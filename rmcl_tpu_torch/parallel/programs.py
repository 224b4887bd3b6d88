"""Rank programs: the sharded entry points driven once each on every rank,
for the multi-rank parity tests and ``chip_smoke.py``.

:func:`run_jobs` is the function :func:`~rmcl_tpu_torch.parallel.mesh.launch`
starts on each rank: it builds each job's mesh (``(shape, axis_names)``; one
mesh a layout, reused), moves the job's inputs (trees of numpy arrays, as the
caller pickled them) to the rank's device, runs the job and returns its
result as numpy, keyed by the job's name. A job takes the whole (global)
inputs, puts its shard in place the way a user would
(:func:`~rmcl_tpu_torch.parallel.mesh.put_sharded`, ``shard_sensor_data``,
``put_scene_sharded``), drives the entry point with the mesh's collective
counts reset just before, and returns the rank's own shard of the result
with the counts read just after, so the caller assembles global results
outside the counted window. Per-rank inputs (random draws) come as a list
indexed by rank.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl.particles import ParticleCloud
from rmcl_tpu_torch.parallel import diff_sharded, scene_shard, sharded
from rmcl_tpu_torch.parallel.mesh import (RAY_AXIS, Mesh, put_replicated, put_sharded,
                                          tree_map)

Job = Tuple[str, Tuple[Tuple[int, ...], Tuple[str, ...]], Callable, dict]


def to_device(tree, device):
    """Every numpy array of ``tree`` as a tensor on ``device``."""
    return tree_map(lambda a: torch.from_numpy(a.copy()).to(device), tree,
                    leaf=np.ndarray)


def to_host(tree):
    """Every tensor of ``tree`` as a numpy array."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def run_jobs(rank: int, world: int, device: str, jobs: Sequence[Job]) -> Dict[str, dict]:
    """Run ``jobs`` in order on this rank; ``{name: result}``."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())  # ranks may share a card
    meshes: Dict[tuple, Mesh] = {}
    out = {}
    for name, layout, fn, kwargs in jobs:
        if layout not in meshes:
            meshes[layout] = Mesh(*layout, device=device)
        mesh = meshes[layout]
        out[name] = to_host(fn(mesh, **to_device(kwargs, mesh.device)))
    return out


def kernel_wrappers() -> dict:
    """The kernels' wrappers by name, each with its ``launches`` count."""
    from rmcl_tpu_torch.ops.closest_cuda import closest_bins, closest_bvh, cp_candidates
    from rmcl_tpu_torch.ops.cull_cuda import cull_blocks, cull_factored, cull_rays
    from rmcl_tpu_torch.ops.raycast_cuda import (intersect_bins, intersect_factored,
                                                 intersect_groups)
    from rmcl_tpu_torch.ops.traverse_cuda import traverse_rays

    return {"K1": intersect_bins, "K2g": intersect_groups, "K3r": cull_rays,
            "K3f": cull_factored, "K3b": cull_blocks, "K4": intersect_factored,
            "K5": traverse_rays, "K6": closest_bvh, "K6b": closest_bins, "K7": cp_candidates}


def _counted(mesh: Mesh, fn):
    """fn() between a reset and a read of the mesh's collective counts and
    the kernels' launch counts: (result, collectives, launches)."""
    wrappers = kernel_wrappers()
    mesh.reset_counts()
    for w in wrappers.values():
        w.launches = 0
    result = fn()
    return result, dict(mesh.counts), {k: w.launches for k, w in wrappers.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _host_ms(mesh: Mesh, fn, reps: int) -> List[float]:
    """Host milliseconds of ``reps`` more calls of fn, each ending in a
    synchronise (and, with other ranks running the same calls, waiting for
    the slowest through the call's collectives)."""
    times = []
    for _ in range(reps):
        _sync(mesh.device)
        t0 = time.perf_counter()
        fn()
        _sync(mesh.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# -- MICP-L --


def cast_job(mesh: Mesh, bvh, orig, dirs, chunk_size: int = 1 << 30):
    """The exact engine's cast of this rank's rays (no collective)."""
    from rmcl_tpu_torch.ops.raycast import cast_rays

    o, d = put_sharded((orig, dirs), mesh)
    h = cast_rays(put_replicated(bvh, mesh), o, d, chunk_size=chunk_size)
    return dict(t=h.t, prim_id=h.prim_id)


def correct_job(mesh: Mesh, accel, sensors, tom: Transform, tbo: Transform, config,
                steps: int = 1, progress: float = 0.0, reps: int = 0):
    """``steps`` chained sharded corrections from ``tom``: the pose after
    each, the last statistics, and the collective counts of each correction;
    with ``reps``, the host ms of that many more corrections from ``tom``
    (each ending in a synchronise)."""
    sensors_s = sharded.shard_sensor_data(sensors, mesh)
    poses, counts = [], []
    t = tom
    launches = []
    for _ in range(steps):
        (t, stats), c, k = _counted(mesh, lambda: sharded.sharded_correct_once(
            accel, sensors_s, t, tbo, progress, mesh, config))
        poses.append(torch.cat([t.rot, t.trans]))
        counts.append(c)
        launches.append(k)
    times = _host_ms(mesh, lambda: sharded.sharded_correct_once(
        accel, sensors_s, tom, tbo, progress, mesh, config), reps)
    return dict(poses=torch.stack(poses), valid_matches=stats.valid_matches,
                valid=stats.valid_measurements, total=stats.total_measurements,
                counts=counts, launches=launches, ms=times)


# -- MCL --


def sensor_update_job(mesh: Mesh, accel, cloud: ParticleCloud, beams, tsb: Transform, config):
    """The sharded sensor update of this rank's particles on injected beams."""
    cloud_s = sharded.shard_cloud(cloud, mesh)
    out, c, k = _counted(mesh, lambda: sharded.sharded_sensor_update(
        accel, cloud_s, None, None, None, tsb, config, mesh, beams=beams))
    return dict(mean=out.likelihood.mean, counts=c, launches=k)


def stats_job(mesh: Mesh, cloud: ParticleCloud):
    (s, m), c, _ = _counted(mesh, lambda: sharded.psum_likelihood_stats(
        sharded.shard_cloud(cloud, mesh), mesh))
    return dict(sum=s, max=m, counts=c)


def _cloud_arrays(cloud: ParticleCloud) -> dict:
    return dict(rot=cloud.poses.rot, trans=cloud.poses.trans, mean=cloud.likelihood.mean,
                sigma=cloud.likelihood.sigma, n_meas=cloud.likelihood.n_meas,
                state_sigma=cloud.state_sigma, alive=cloud.alive)


def gladiator_draws_job(mesh: Mesh, cloud: ParticleCloud, draws: List[tuple], config,
                        shifts=None):
    """One sharded tournament on given per-rank draws (enemy, normals)."""
    enemy, normals = draws[mesh.rank]
    cloud_s = sharded.shard_cloud(cloud, mesh)
    out, c, _ = _counted(mesh, lambda: sharded.sharded_gladiator_from_draws(
        cloud_s, enemy.long(), normals, config, mesh, shifts=shifts))
    return dict(cloud=_cloud_arrays(out), counts=c)


def gladiator_mixing_job(mesh: Mesh, cloud: ParticleCloud, config, ticks: int, seed: int,
                         target_x: float, doubling: bool = False):
    """``ticks`` sharded tournaments on the rank's own generator (seeded
    from (seed, rank)), the ring of one shift or the doubling schedule; the
    rank's share of particles within 0.1 m (in x) of ``target_x`` after each
    tick, and its final x."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed * 1000 + mesh.rank)
    cloud_s = sharded.shard_cloud(cloud, mesh)
    n_dev = mesh.axis_size(RAY_AXIS)
    near = []
    for t in range(ticks):
        shifts = sharded.gladiator_mixing_shifts(t, n_dev) if doubling else None
        cloud_s = sharded.sharded_gladiator_resample(cloud_s, gen, config, mesh, shifts=shifts)
        near.append(torch.mean((torch.abs(cloud_s.poses.trans[:, 0] - target_x) < 0.1)
                               .to(torch.float32)))
    return dict(near=torch.stack(near), x=cloud_s.poses.trans[:, 0])


def residual_draws_job(mesh: Mesh, cloud: ParticleCloud, draws: List[tuple], config, n_target):
    """The sharded dynamic residual resampler on given per-rank draws (u0,
    normals)."""
    u0, normals = draws[mesh.rank]
    cloud_s = sharded.shard_cloud(cloud, mesh)
    out, c, _ = _counted(mesh, lambda: sharded.sharded_residual_dynamic_from_draws(
        cloud_s, u0, normals, config, n_target, mesh))
    return dict(cloud=_cloud_arrays(out), counts=c)


def mcl_loop_job(mesh: Mesh, bvh, cloud: ParticleCloud, points, mask, steps: int, seed: int,
                 samples: int = 48, dist_sigma: float = 0.4):
    """The whole MCL loop on a particle-sharded cloud: motion update, the
    sharded sensor update (one beam stream, the same on every rank) and the
    sharded tournament (the rank's own stream); the rank's final cloud."""
    from rmcl_tpu_torch.mcl.motion import MotionUpdateConfig, motion_update
    from rmcl_tpu_torch.mcl.resampling import ResamplerConfig
    from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig

    dev = mesh.device
    beams_gen = torch.Generator(device=dev).manual_seed(seed)
    own_gen = torch.Generator(device=dev).manual_seed(seed * 1000 + 1 + mesh.rank)
    cloud_s = sharded.shard_cloud(cloud, mesh)
    tsb = Transform.identity(device=dev)
    mcfg = MotionUpdateConfig.create()
    scfg = SensorUpdateConfig.create(samples=samples, dist_sigma=dist_sigma)
    rcfg = ResamplerConfig.create()
    for _ in range(steps):
        cloud_s = motion_update(cloud_s, Transform.identity(device=dev), 0.1, mcfg)
        cloud_s = sharded.sharded_sensor_update(bvh, cloud_s, beams_gen, points, mask, tsb,
                                                scfg, mesh)
        cloud_s = sharded.sharded_gladiator_resample(cloud_s, own_gen, rcfg, mesh)
    return dict(cloud=_cloud_arrays(cloud_s))


def mcl_shard_job(mesh: Mesh, bins, bvh, cloud: ParticleCloud, beams, tsb: Transform, config,
                  bvh_config, bvh_particles: int, n_target: int, path: str, seed: int,
                  reps: int = 0):
    """One sharded MCL round on this rank's particles: the binned sensor
    update of its share of ``cloud``, the bvh update of its share of the
    first ``bvh_particles``, a tournament on the doubling schedule's first
    shift, the dynamic residual resampler to ``n_target`` live particles,
    the likelihood statistics and a ``save_sharded``/``load_sharded`` round
    trip; each step's collectives and launches, the likelihoods, and the
    rank's peak device memory."""
    from rmcl_tpu_torch.mcl.resampling import ResamplerConfig
    from rmcl_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cloud_s = sharded.shard_cloud(cloud, mesh)
    part = sharded.shard_cloud(cloud.map(lambda x: x[:bvh_particles]), mesh)
    del cloud
    update = lambda: sharded.sharded_sensor_update(bins, cloud_s, None, None, None, tsb, config,
                                                   mesh, beams=beams)
    out, c_update, k_update = _counted(mesh, update)
    ms = _host_ms(mesh, update, reps)
    out_b, c_bvh, k_bvh = _counted(mesh, lambda: sharded.sharded_sensor_update(
        bvh, part, None, None, None, tsb, bvh_config, mesh, beams=beams))
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + mesh.rank)
    rcfg = ResamplerConfig.create()
    shifts = sharded.gladiator_mixing_shifts(0, mesh.axis_size(RAY_AXIS))
    glad, c_glad, _ = _counted(mesh, lambda: sharded.sharded_gladiator_resample(
        out, gen, rcfg, mesh, shifts=shifts))
    resid, c_resid, _ = _counted(mesh, lambda: sharded.sharded_residual_resample_dynamic(
        glad, gen, rcfg, n_target, mesh))
    (lsum, lmax), c_stats, _ = _counted(mesh, lambda: sharded.psum_likelihood_stats(resid, mesh))
    save_sharded(path, resid)
    back = load_sharded(path, ParticleCloud.create(resid.capacity, device=dev))
    same = all(torch.equal(a, b) for a, b in zip(_cloud_arrays(back).values(),
                                                 _cloud_arrays(resid).values()))
    _sync(dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return dict(mean=out.likelihood.mean, bvh_mean=out_b.likelihood.mean,
                counts=dict(update=c_update, bvh=c_bvh, gladiator=c_glad, residual=c_resid,
                            stats=c_stats),
                launches=dict(update=k_update, bvh=k_bvh), shifts=list(shifts),
                alive=torch.sum(resid.alive.to(torch.int64)), lik_sum=lsum, lik_max=lmax,
                checkpoint_bitwise=same, peak_bytes=peak, ms=ms)


def checkpoint_job(mesh: Mesh, cloud: ParticleCloud, path: str):
    """``save_sharded`` of this rank's shard, then ``load_sharded`` onto a
    template on the mesh's device: whether every tensor came back bit for
    bit."""
    from rmcl_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    cloud_s = sharded.shard_cloud(cloud, mesh)
    save_sharded(path, cloud_s)
    back = load_sharded(path, ParticleCloud.create(cloud_s.capacity, device=mesh.device))
    same = all(torch.equal(a, b) and a.device == b.device
               for a, b in zip(_cloud_arrays(back).values(), _cloud_arrays(cloud_s).values()))
    return dict(bitwise=same)


# -- the backward and the scene shards --


def backward_job(mesh: Mesh, bins, verts, faces, trans, dirs, pose_id, wrt: str, cast_kw=None,
                 reps: int = 0):
    """The sharded value and gradient of this rank's rays (and the host ms
    of ``reps`` more evaluations)."""
    d, pid = put_sharded((dirs, pose_id), mesh)
    bins = put_replicated(bins, mesh)
    run = lambda: diff_sharded.sharded_range_value_and_grad(
        bins, verts, faces, trans, d, pid, mesh, wrt=wrt, **(cast_kw or {}))
    (loss, grad), c, k = _counted(mesh, run)
    return dict(loss=loss, grad=grad, counts=c, launches=k, ms=_host_ms(mesh, run, reps))


def scene_job(mesh: Mesh, sbins, orig, dirs, forwarded: bool = False, cast_kw=None,
              reps: int = 0):
    """A scene-sharded cast: this rank's shard of the stacked bins, its rays
    (its shard over ``"rays"`` on a 2-D mesh, all of them on a 1-D one) and
    its hits (and the host ms of ``reps`` more casts)."""
    bins_local = scene_shard.put_scene_sharded(sbins, mesh)
    if RAY_AXIS in mesh.shape:
        orig, dirs = put_sharded((orig, dirs), mesh)
    kw = dict(cast_kw or {})
    if forwarded:
        boxes = scene_shard.shard_boxes(sbins).to(mesh.device)
        cast = lambda: scene_shard.cast_rays_scene_forwarded(bins_local, orig, dirs, mesh,
                                                             boxes, **kw)
    else:
        cast = lambda: scene_shard.cast_rays_scene_sharded(bins_local, orig, dirs, mesh, **kw)
    h, c, k = _counted(mesh, cast)
    return dict(t=h.t, hit=h.hit, prim_id=h.prim_id, normal=h.normal, counts=c, launches=k,
                ms=_host_ms(mesh, cast, reps))


def assemble(results: Sequence[dict], key: str, ranks: Sequence[int] = None) -> np.ndarray:
    """The global array of a sharded result: the ranks' shards of ``key``
    (a path of dict keys split by '.') in rank order (``ranks``, default
    all)."""
    ranks = range(len(results)) if ranks is None else ranks
    parts = []
    for r in ranks:
        x = results[r]
        for k in key.split("."):
            x = x[k]
        parts.append(x)
    return np.concatenate(parts)
