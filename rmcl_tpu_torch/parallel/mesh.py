"""Named device axes over ``torch.distributed`` ranks, the port's multi-device
substrate.

Counterpart of ``rmcl_tpu.parallel.mesh``. The JAX package runs one program
over a ``jax.sharding.Mesh`` and lets ``shard_map`` hand each device its
shard; here each rank is a process that runs the same local body (SPMD),
holds only its own shard, and spells every collective out. A :class:`Mesh`
lays the ranks of the default process group out on named axes (row-major:
the last axis varies fastest), with one process group per line of each axis,
and offers the collectives the JAX bodies use (``psum``, ``pmin``,
``pmax``, ``all_gather``, ``ppermute``), each counted by kind in
``Mesh.counts``: the counterpart of the HLO collective counts the JAX tests
pin.

Axis convention as in the JAX package: ``"rays"`` is the data axis (rays and
particles), ``"scene"`` the map-partition axis of
:mod:`rmcl_tpu_torch.parallel.scene_shard`.

:func:`launch` starts the ranks (one process each, ``spawn``) and initialises
the group for the backend the caller names: what ``jax.distributed.initialize``
and the XLA device-count flag provide to the JAX package. Every result
crosses back to the caller as a pickle, so rank programs return host data.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import queue
import socket
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rmcl_tpu_torch._device import resolve_device

Tensor = torch.Tensor

RAY_AXIS = "rays"
SCENE_AXIS = "scene"

COLLECTIVES = ("all_reduce", "all_gather", "permute")


def tree_map(fn: Callable[[Any], Any], tree, leaf: type = Tensor):
    """``fn`` on every ``leaf`` (a tensor, by default) of a tree of
    dataclasses, tuples, lists and dicts; other leaves (ints, floats,
    strings, None) pass unchanged."""
    if isinstance(tree, leaf):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), leaf)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, leaf) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaf) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a tree, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


class Mesh:
    """The ranks of the default process group on named axes.

    ``shape`` (one size an axis) must multiply to the world size; rank r sits
    at ``np.unravel_index(r, shape)``. ``device`` is where this rank's shards
    live. Building a mesh is collective: every rank creates every axis line's
    group, in the same order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device="cuda"):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks; "
                             f"the process group has {world}")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.device = resolve_device(device)
        self.backend = dist.get_backend()
        self.rank = rank
        self._index = dict(zip(axis_names, (int(i) for i in np.unravel_index(rank, shape))))
        self._groups = {}
        grid = np.arange(world).reshape(shape)
        for a, name in enumerate(axis_names):
            for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    self._groups[name] = group
        self.counts = {k: 0 for k in COLLECTIVES}

    def axis_index(self, axis: str) -> int:
        return self._index[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def reset_counts(self) -> None:
        self.counts = {k: 0 for k in COLLECTIVES}

    # -- collectives (each counted once a call) --

    def _all_reduce(self, x: Tensor, axis: str, op) -> Tensor:
        out = x.clone()
        dist.all_reduce(out, op=op, group=self._groups[axis])
        self.counts["all_reduce"] += 1
        return out

    def psum(self, x: Tensor, axis: str) -> Tensor:
        return self._all_reduce(x, axis, dist.ReduceOp.SUM)

    def pmin(self, x: Tensor, axis: str) -> Tensor:
        return self._all_reduce(x, axis, dist.ReduceOp.MIN)

    def pmax(self, x: Tensor, axis: str) -> Tensor:
        return self._all_reduce(x, axis, dist.ReduceOp.MAX)

    def _staged(self, x: Tensor) -> Tensor:
        # gloo moves CUDA tensors for all_reduce only: its all_gather and
        # point-to-point ops take host tensors, so this backend alone stages
        # them through host memory (NCCL takes the device tensors as they are)
        return x.cpu() if self.backend == "gloo" else x

    def all_gather(self, x: Tensor, axis: str) -> Tensor:
        """(axis size, *x.shape): every rank's x along ``axis``, in index order."""
        src = self._staged(x.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=self._groups[axis])
        self.counts["all_gather"] += 1
        return torch.stack(parts).to(x.device)

    def ppermute(self, x: Tensor, axis: str, shift: int) -> Tensor:
        """The x of the rank ``shift`` places before this one on ``axis``
        (JAX's ``ppermute`` with the pairs ``(i, (i + shift) % n)``)."""
        n = self.shape[axis]
        i = self._index[axis]
        ranks = dist.get_process_group_ranks(self._groups[axis])
        src = self._staged(x.contiguous())
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n], self._groups[axis]),
               dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], self._groups[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.counts["permute"] += 1
        return out.to(x.device)


def make_mesh(n_devices: Optional[int] = None, axis: str = RAY_AXIS, device="cuda") -> Mesh:
    """1-D mesh over every rank of the group (``n_devices``, when given, must
    be the world size: a rank outside the mesh would have nothing to run)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return Mesh((n,), (axis,), device=device)


def shard_rays(mesh: Mesh, axis: str = RAY_AXIS):
    """The slicing rule for (N, ...) ray/particle tensors: this rank's
    contiguous 1/size of the leading dim, on the mesh's device. N must
    divide evenly (pad upstream, :func:`pad_to_multiple`)."""
    k, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def rule(x: Tensor) -> Tensor:
        n = x.shape[0]
        if n % k:
            raise ValueError(f"leading dim {n} does not split over {k} ranks of {axis!r}")
        return x[i * (n // k):(i + 1) * (n // k)].to(mesh.device)

    return rule


def replicated(mesh: Mesh):
    """The slicing rule for replicated tensors: the whole tensor, on the
    mesh's device."""
    return lambda x: x.to(mesh.device)


def put_sharded(tree, mesh: Mesh, axis: str = RAY_AXIS):
    """This rank's shard of every (N, ...) tensor of ``tree``."""
    return tree_map(shard_rays(mesh, axis), tree)


def put_replicated(tree, mesh: Mesh):
    """``tree`` on the mesh's device, whole (no collective: every rank
    already holds the same value, as JAX's ``_place`` assumes)."""
    return tree_map(replicated(mesh), tree)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


# -- launching ranks --


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, backend, port, timeout_s, work, results):
    try:
        fn, args = work.get()
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world_size: int, backend: str, args: tuple = (),
           timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks, one
    ``spawn``ed process each, in a process group of ``backend`` (``"gloo"``
    or ``"nccl"``, named by the caller: nothing picks one). ``fn`` must be
    importable by a fresh interpreter (a module-level function) and return
    something picklable. Returns the results by rank. Raises if a rank
    raises (with its traceback), dies, or the ranks outlast ``timeout``
    seconds, which also bounds every collective; no rank outlives the call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    # the work travels by queue, not as process arguments: a start blocks
    # until the child has read its arguments, which would start the ranks
    # one after another whenever the arguments outgrow a pipe's buffer
    work = [ctx.Queue() for _ in range(world_size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, port, timeout, work[r], results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    for q in work:
        q.put((fn, args))
    out, errors = {}, []
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(out) + len(errors) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} outlasted {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode != 0 and r not in out]
                if dead and not errors:
                    # a rank that died without reporting (killed, crashed)
                    # leaves the others waiting in a collective
                    raise RuntimeError(f"rank(s) {dead} of {fn.__name__} died with exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break  # the other ranks may wait forever on the failed one
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on "
                               + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors and len(out) == world_size else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
