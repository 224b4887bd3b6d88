"""Checkpoint and resume of localization state.

Counterpart of ``rmcl_tpu.utils.checkpoint`` (the reference has no
checkpointing; recovery there is re-initialization): a particle filter's
cloud and random stream, or a tracker's Tom, Tbo and convergence, in one
NPZ. The MICP snapshot has the JAX package's layout, so either package
loads the other's; the MCL snapshot keeps the ``torch.Generator``'s state
where the JAX package keeps its ``jax.random`` key (the two streams differ,
so neither resumes the other's).

Sharded state (:func:`save_sharded`, :func:`load_sharded`; the JAX package
uses an orbax checkpoint, which neither machine has): every rank writes its
own shard of a tree of tensors with ``torch.save`` (``rank{r}.pt``, the
tree's tensors in order), and rank 0 writes ``index.json`` with the world
size and each rank's leaf shapes and types. Plain files rather than
``torch.distributed.checkpoint``, whose sharded form is built around DTensor
and global shapes, where these are plain per-rank tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.convert import particles_from_arrays, transform_from_arrays
from rmcl_tpu_torch.convert import to_numpy as _np
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.parallel.mesh import tree_leaves, tree_map


def _extra(z) -> Dict[str, np.ndarray]:
    return {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}


def save_mcl_state(path: str, cloud: ParticleCloud, generator: torch.Generator,
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot a particle filter and its generator's state to NPZ."""
    data = {
        "poses_rot": _np(cloud.poses.rot),
        "poses_trans": _np(cloud.poses.trans),
        "lik_mean": _np(cloud.likelihood.mean),
        "lik_sigma": _np(cloud.likelihood.sigma),
        "lik_n": _np(cloud.likelihood.n_meas),
        "state_sigma": _np(cloud.state_sigma),
        "alive": _np(cloud.alive),
        "generator": _np(generator.get_state()),
    }
    for k, v in (extra or {}).items():
        data[f"extra_{k}"] = _np(v)
    np.savez_compressed(path, **data)


def load_mcl_state(path: str, device="cuda"):
    """Restore ``(cloud, generator, extra)`` from an NPZ snapshot, the cloud
    and the generator on ``device``."""
    dev = resolve_device(device)
    z = np.load(path)
    cloud = particles_from_arrays(dict(
        rot=z["poses_rot"], trans=z["poses_trans"], mean=z["lik_mean"], sigma=z["lik_sigma"],
        n_meas=z["lik_n"], state_sigma=z["state_sigma"], alive=z["alive"]), device=dev)
    generator = torch.Generator(device=dev)
    generator.set_state(torch.from_numpy(z["generator"]))
    return cloud, generator, _extra(z)


def save_micp_state(path: str, tom: Transform, tbo: Transform, convergence, extra=None) -> None:
    data = {
        "tom_rot": _np(tom.rot),
        "tom_trans": _np(tom.trans),
        "tbo_rot": _np(tbo.rot),
        "tbo_trans": _np(tbo.trans),
        "convergence": _np(convergence),
    }
    for k, v in (extra or {}).items():
        data[f"extra_{k}"] = _np(v)
    np.savez_compressed(path, **data)


def load_micp_state(path: str, device="cuda"):
    """Returns ``(tom, tbo, convergence, extra)`` on ``device``, symmetric
    with :func:`save_micp_state`'s ``extra`` dict."""
    dev = resolve_device(device)
    z = np.load(path)
    tom = transform_from_arrays(z["tom_rot"], z["tom_trans"], device=dev)
    tbo = transform_from_arrays(z["tbo_rot"], z["tbo_trans"], device=dev)
    convergence = torch.from_numpy(np.asarray(z["convergence"], np.float32)).to(dev)
    return tom, tbo, convergence, _extra(z)


# -- sharded state --


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_sharded(path: str, tree) -> None:
    """Write this rank's shard of ``tree`` (dataclasses, tuples, lists and
    dicts of tensors) under the directory ``path``. Collective when a process
    group is up: every rank calls it, and it returns once all have written."""
    rank, world = _rank_world()
    os.makedirs(path, exist_ok=True)
    leaves = [x.detach().cpu() for x in tree_leaves(tree)]
    torch.save(leaves, os.path.join(path, f"rank{rank}.pt"))
    shapes = [[list(x.shape), str(x.dtype)] for x in leaves]
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, shapes)
    else:
        gathered = [shapes]
    if rank == 0:
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump({"world_size": world, "leaves": gathered}, f)
    if world > 1:
        dist.barrier()


def load_sharded(path: str, template):
    """Restore this rank's shard written by :func:`save_sharded` into the
    structure of ``template``, each tensor on its template tensor's device.
    Refuses a checkpoint written by another number of ranks, or whose
    leaves differ from the template's in count, shape or type."""
    rank, world = _rank_world()
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    if index["world_size"] != world:
        raise ValueError(f"checkpoint {path} was written by {index['world_size']} ranks; "
                         f"this group has {world}")
    leaves = torch.load(os.path.join(path, f"rank{rank}.pt"), weights_only=True)
    want = tree_leaves(template)
    if len(leaves) != len(want) or any(
            x.shape != w.shape or x.dtype != w.dtype for x, w in zip(leaves, want)):
        raise ValueError(f"checkpoint {path} rank {rank}: leaves "
                         f"{[(tuple(x.shape), x.dtype) for x in leaves]} do not match the "
                         f"template's {[(tuple(w.shape), w.dtype) for w in want]}")
    it = iter(leaves)
    return tree_map(lambda w: next(it).to(w.device), template)
