#!/usr/bin/env python3
"""Rays that the dense binned engine decides apart from the exact engine at
budgets where no block saturates, JAX package and PyTorch port side by side
on the CPU.

Phase 4's building (``make_building_scene(subdiv=45)``, bins of 64 in
supers of 64, both packages' default order), VLP-16 scans from the first
poses of ``chip_smoke.py`` phase 14b (uniform over the floor at 1.5 m with
a yaw, seed 14), 128-ray blocks at c_super 3,072 and c_bin 12,288 (phase
14b's audited budgets; no block saturates). One JSON line a pose: per
package the rays whose hit or winner differs from the exact engine's
(``cast_rays`` on the BVH) beyond a near-tie, whether the packages' sets
coincide, and for the port's how many exact winners' bins the cull left
out of the ray's block list (none: the port's cone-box test holds the
slab's axial interval against an axial bound; JAX's leaves some out). For
each ray left out, the cone-box test of
the ray's own sub-block cone against the winner's super and bin is taken
apart clause by clause (``ops/cull_cuda.py::_cone_box_test``, the same
arithmetic as JAX's ``_cone_box_test``, which is run on the same inputs
too): the level that rejects (super, bin; this cull has no hyper or mid
level), and which clause fails there: the slab's ``tn <= tf`` (with the
refined cone radius r1; with r0 as well), the ball's ``d_near`` raising
tn above the slab's tf, ``d_far`` lowering tf, ``tf >= 0``, ``tn <= t_hi``
or ``d_near <= t_hi``; with the box's thinnest extent and the cone's angle.
One more JSON line sums the clauses over the poses. Run from the repo
root (~3 minutes):

    python -m scripts.torch_flat_bin_probe
"""

import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rmcl_tpu.bvh.bins import build_bins  # noqa: E402
from rmcl_tpu.geom.mesh import make_building_scene  # noqa: E402
from rmcl_tpu.ops import raycast_binned as jrb  # noqa: E402
from rmcl_tpu_torch.bvh.bins import build_bins as t_build_bins  # noqa: E402
from rmcl_tpu_torch.bvh.builder import build_bvh  # noqa: E402
from rmcl_tpu_torch.math.se3 import Transform  # noqa: E402
from rmcl_tpu_torch.ops import raycast_binned as trb  # noqa: E402
from rmcl_tpu_torch.ops.cull_cuda import (_capped_bounds, _cone_box_test,  # noqa: E402
                                          _subblock_bounds)
from rmcl_tpu_torch.ops.raycast import cast_rays  # noqa: E402
from rmcl_tpu_torch.sensors.models import SphericalModel  # noqa: E402

POSES = 3
BUDGETS = dict(c_super=3072, c_bin=12288)
FLOOR = (24.0, 18.0)
SUB_BLOCKS = 4


def clauses(cone, box):
    """The clauses of ``_cone_box_test`` for one cone (11,) and one box (6,),
    step by step in its own arithmetic: which of them reject."""
    from rmcl_tpu_torch.ops.cull_cuda import _norm

    oc, oh, a, tan_th, t_hi = cone[0:3], cone[3:6], cone[6:9], cone[9], cone[10]
    bmin, bmax = box[0:3], box[3:6]
    inv = 1.0 / torch.where(torch.abs(a) < 1e-30, 1e-30, a)
    b0, b1 = bmin - oh - oc, bmax + oh - oc
    d_near = _norm(torch.clamp(torch.maximum(b0, -b1), min=0.0))
    d_far = _norm(torch.maximum(b1, -b0))
    s_perp = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))

    def slab(r):
        t0, t1 = (b0 - r * s_perp) * inv, (b1 + r * s_perp) * inv
        return torch.amax(torch.minimum(t0, t1)), torch.amin(torch.maximum(t0, t1))

    tn0, tf0 = slab(t_hi * tan_th)
    tn_s, tf_s = slab(torch.clamp(torch.minimum(torch.clamp(tf0, min=0.0), t_hi), min=0.0)
                      * tan_th)
    tn, tf = torch.maximum(tn_s, d_near), torch.minimum(tf_s, d_far)
    failed = []
    if not tn0 <= tf0:
        failed.append("slab_r0")
    if not tn_s <= tf_s:
        failed.append("slab_r1")
    elif not tn <= tf:
        failed.append("d_near>tf_slab" if d_near > tf_s else "d_far<tn_slab")
    if not tf >= 0.0:
        failed.append("tf<0")
    if not tn <= t_hi:
        failed.append("tn>t_hi")
    if not d_near <= t_hi:
        failed.append("d_near>t_hi")
    return failed, dict(d_near=float(d_near), tn_slab=float(tn_s), tf_slab=float(tf_s),
                        thinnest=float(torch.amin(bmax - bmin)),
                        cone_deg=float(torch.rad2deg(torch.atan(tan_th))))


def main():
    mesh = make_building_scene(subdiv=45)
    jb = build_bins(mesh, bin_size=64, bins_per_super=64)
    tb = t_build_bins(mesh, bin_size=64, bins_per_super=64, device="cpu")
    bvh = build_bvh(mesh, device="cpu")
    model = SphericalModel.vlp16()
    lim = dict(t_min=model.range.min, t_max=model.range.max)
    rng = np.random.default_rng(14)
    pose = np.zeros((100, 6), np.float32)
    pose[:, :2] = rng.uniform((0.0, 0.0), FLOOR, (100, 2))
    pose[:, 2] = 1.5
    pose[:, 5] = rng.uniform(-np.pi, np.pi, 100)
    o_s, d_s = model.rays("cpu")
    # the bin of each face, from the packed prim ids (-1: padding)
    prim = tb.tri[:, 12, :].reshape(-1).long()
    face_bin = torch.full((mesh.n_faces,), -1, dtype=torch.long)
    face_bin[prim[prim >= 0]] = torch.nonzero(prim >= 0).squeeze(1) // tb.bin_size
    total = {}
    print(json.dumps({"faces": mesh.n_faces,
                      "bins_bitwise": bool(np.array_equal(np.asarray(jb.tri), tb.tri.numpy()))}),
          flush=True)
    for p in range(POSES):
        tsm = Transform.from_pose_tuple(torch.from_numpy(pose[p]), device="cpu")
        o, d = tsm.apply(o_s).contiguous(), tsm.rotate(d_s).contiguous()
        ex = cast_rays(bvh, o, d, **lim)
        th = trb.cast_rays_binned(tb, o, d, block_size=128, **BUDGETS, **lim)
        jh = jrb.cast_rays_binned(jb, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                  block_size=128, **BUDGETS, **lim)

        def apart(hit, t, prim_id):
            both = hit & ex.hit.numpy()
            rel = np.abs(t - ex.t.numpy()) / np.abs(ex.t.numpy())
            other = both & (prim_id != ex.prim_id.numpy()) & (rel > 1e-4)
            return (hit != ex.hit.numpy()) | other

        a_t = apart(th.hit.numpy(), th.t.numpy(), th.prim_id.numpy())
        a_j = apart(np.asarray(jh.hit), np.asarray(jh.t), np.asarray(jh.prim_id))
        n = o.shape[0]
        inputs, sat = trb._kernel_inputs(tb, o, d, torch.full((n,), model.range.min),
                                         torch.full((n,), model.range.max), 128,
                                         BUDGETS["c_super"], BUDGETS["c_bin"], 4)
        rays = torch.from_numpy(np.nonzero(a_t & ex.hit.numpy())[0])
        blk = rays // 128
        want = face_bin[ex.prim_id[rays].long()]
        slot = torch.arange(inputs[4].shape[1])
        listed = ((inputs[4][blk] == want[:, None]) & (slot < inputs[5][blk][:, None])).any(1)
        # the left-out rays' own sub-block cones against the winner's super
        # and bin: which level rejects, and which clause there
        blocks = trb._pad_rays(o, d, torch.full((n,), model.range.min),
                               torch.full((n,), model.range.max), 128)
        cones, _ = _capped_bounds(tb, _subblock_bounds(*blocks, SUB_BLOCKS))
        left = rays[~listed]
        causes, examples = {}, []
        for ray, gbin in zip(left.tolist(), want[~listed].tolist()):
            cone = cones[ray // 128, (ray % 128) // (128 // SUB_BLOCKS)]
            for level, box in (("super", tb.super_aabb[gbin // tb.bins_per_super]),
                               ("bin", tb.bin_aabb[gbin])):
                failed, detail = clauses(cone, box)
                port_ok = bool(_cone_box_test(*(x[None] for x in (
                    cone[0:3], cone[3:6], cone[6:9])), cone[9:10], cone[10:11],
                    box[None, 0:3], box[None, 3:6], cone[11:12])[0][0])
                jax_ok = bool(np.asarray(jrb._cone_box_test(*(jnp.asarray(x[None].numpy()) for x in (
                    cone[0:3], cone[3:6], cone[6:9])), jnp.asarray(cone[9:10].numpy()),
                    jnp.asarray(cone[10:11].numpy()), jnp.asarray(box[None, 0:3].numpy()),
                    jnp.asarray(box[None, 3:6].numpy())))[0][0])
                if failed or not port_ok or not jax_ok:
                    key = f"{level}:{'+'.join(failed)}:port_rejects={not port_ok}:jax_rejects={not jax_ok}"
                    causes[key] = causes.get(key, 0) + 1
                    total[key] = total.get(key, 0) + 1
                    if len(examples) < 3:
                        examples.append(dict(ray=ray, level=level, failed=failed, **detail))
                    break
            else:
                causes["own_cone_passes"] = causes.get("own_cone_passes", 0) + 1
                total["own_cone_passes"] = total.get("own_cone_passes", 0) + 1
        print(json.dumps({"pose": p, "rays": n, "saturated_blocks": int(sat.sum()),
                          "port_apart": int(a_t.sum()), "jax_apart": int(a_j.sum()),
                          "same_rays": bool(np.array_equal(a_t, a_j)),
                          "port_winner_bin_left_out": int((~listed).sum()),
                          "rejected_by": causes, "examples": examples}), flush=True)
    print(json.dumps({"poses": POSES, "rejected_by": total}), flush=True)


if __name__ == "__main__":
    main()
