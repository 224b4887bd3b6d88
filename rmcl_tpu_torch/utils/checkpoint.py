"""Checkpoint and resume of localization state.

Counterpart of ``rmcl_tpu.utils.checkpoint`` (the reference has no
checkpointing; recovery there is re-initialization): a particle filter's
cloud and random stream, or a tracker's Tom, Tbo and convergence, in one
NPZ. The MICP snapshot has the JAX package's layout, so either package
loads the other's; the MCL snapshot keeps the ``torch.Generator``'s state
where the JAX package keeps its ``jax.random`` key (the two streams differ,
so neither resumes the other's). The multi-device ``save_sharded`` /
``load_sharded`` wait for the port's multi-device slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device
from rmcl_tpu_torch.convert import particles_from_arrays, transform_from_arrays
from rmcl_tpu_torch.convert import to_numpy as _np
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl.particles import ParticleCloud


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
