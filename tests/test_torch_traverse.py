"""K5's plain version, which the wrapper runs on CPU tensors and the
kernel is held to bitwise on the card: it returns each ray's least leaf t
(brute force over every leaf with the same arithmetic), the lowest slot
among leaves tied at that t, nothing for an empty segment, and ``cast_rays``
in chunks equals one call. Its parity with the JAX package is in
tests/test_torch_raycast.py."""

import numpy as np
import pytest
import torch

from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.geom import mesh as tm
from rmcl_tpu_torch.ops import raycast as tr
from rmcl_tpu_torch.ops.traverse_cuda import (_box_enter, _leaf_t, traverse_rays,
                                              traverse_rays_reference)

torch.set_num_threads(2)

GRAZE_FRAC = 0.005  # as tests/test_torch_raycast.py: rays through an edge may flip

MESHES = {
    "room": lambda: tm.make_room_scene(n_pillars=4, seed=3),
    "building": lambda: tm.make_building_scene(subdiv=4),
    "sphere": lambda: tm.make_sphere(24, 32, radius=5.0),
}
_BVHS = {}


def _bvh(name):
    if name not in _BVHS:
        mesh = MESHES[name]()
        _BVHS[name] = (mesh, build_bvh(mesh, device="cpu"))
    return _BVHS[name]


def _rays(mesh, kind, n=3000, seed=0):
    """Scattered rays from inside the mesh's box, or a 180 x 16 scan from
    near its centre; t_min 0, t_max unbounded."""
    lo, hi = mesh.aabb()
    c, h = (lo + hi) / 2, (hi - lo) / 2
    rng = np.random.default_rng(seed)
    if kind == "scan":
        az = np.linspace(-np.pi, np.pi, 180, endpoint=False)
        el = np.linspace(-0.5, 0.5, 16)
        el, az = np.meshgrid(el, az + 0.4, indexing="ij")
        d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
        d = d.reshape(-1, 3)
        o = np.broadcast_to(c + 0.1 * h, d.shape)
    else:
        o = rng.uniform(c - 0.8 * h, c + 0.8 * h, (n, 3))
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)) for x in (o, d))
    return o, d, torch.zeros(o.shape[0]), torch.full((o.shape[0],), 3.0e38)


@pytest.mark.parametrize("name,kind", [
    ("room", "scan"), ("room", "scattered"), ("building", "scan"), ("building", "scattered"),
    ("sphere", "scan"), ("sphere", "scattered"),
])
def test_walk_returns_the_least_leaf_t(name, kind):
    """Against every leaf's t: the walk returns the least t, bitwise, and
    misses where no leaf is hit. Only a ray whose least leaf some box above
    it can prune (its t rounding below the box's t_near) may stray, on at
    most GRAZE_FRAC of the rays, and never below the least. The winner's t
    is its own leaf's."""
    mesh, bvh = _bvh(name)
    o, d, t_min, t_max = _rays(mesh, kind)
    t, slot, visits = traverse_rays_reference(bvh.nodes, bvh.root_link, o, d, t_min, t_max,
                                              visits=True)
    leaves, t_all, reach = _leaves_and_reach(bvh, o, d)
    least, col = t_all.min(dim=1)
    hit = torch.isfinite(least)
    assert float(hit.float().mean()) > 0.5  # the rays really hit geometry
    want = torch.where(hit, least, t_max)
    sure = ~hit | reach[torch.arange(o.shape[0]), col]
    assert torch.equal(t[sure], want[sure]) and torch.equal(slot[sure] >= 0, hit[sure])
    assert float((t != want).float().mean()) <= GRAZE_FRAC
    assert bool((t >= want).all())
    won = slot >= 0
    own = t_all[won, torch.searchsorted(leaves, slot[won].long())]
    assert torch.equal(t[won], own)
    assert int(visits.sum(1).max()) <= bvh.n_slots


def _tie_rays(mesh, n=400, seed=21):
    """Rays from inside the mesh's box at the midpoints of triangle edges
    and at vertices, where two or more triangles meet."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices.astype(np.float32)
    f = mesh.faces[rng.integers(0, mesh.faces.shape[0], n)]
    target = np.concatenate([(v[f[:, 0]] + v[f[:, 1]]) * np.float32(0.5),
                             v[rng.integers(0, v.shape[0], n)]])
    lo, hi = mesh.aabb()
    o = rng.uniform(lo + 0.2 * (hi - lo), hi - 0.2 * (hi - lo), target.shape).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def _leaves_and_reach(bvh, o, d):
    """Every leaf's t for every ray, with the kernels' arithmetic (inf where
    the triangle is not hit), and whether every box above the leaf passes
    the slab test against the ray's least t, so that no walk can prune the
    leaf: (leaf slots, t (R, L), reach (R, L))."""
    ni, nf = bvh.nodes.view(torch.int32), bvh.nodes
    R = o.shape[0]
    ox, oy, oz = o.unbind(1)
    ix, iy, iz = (1.0 / torch.where(d[:, k].abs() > 1e-20, d[:, k], 1e-20) for k in range(3))
    zero = torch.zeros(R)
    leaves, ts = [], []
    stack = [int(bvh.root_link)]
    while stack:  # preorder: a leaf's t, before any box needs it
        link = stack.pop()
        if link < 0:
            w = nf[~link][None].expand(R, 16)
            t, ok = _leaf_t(w, ox, oy, oz, *d.unbind(1), zero)
            leaves.append(~link)
            ts.append(torch.where(ok, t, torch.inf))
            continue
        first = int(ni[link, 12])
        stack += [int(ni[~first if first < 0 else first, 13]), first]
    t = torch.stack(ts, 1)
    least = t.min(dim=1).values
    reach = torch.ones((R, bvh.n_slots), dtype=torch.bool)
    stack = [int(bvh.root_link)]
    while stack:
        link = stack.pop()
        if link < 0:
            continue
        box = _box_enter(nf[link][None].expand(R, 16), ox, oy, oz, ix, iy, iz, zero, least)
        first = int(ni[link, 12])
        for child in (first, int(ni[~first if first < 0 else first, 13])):
            reach[:, ~child if child < 0 else child] = reach[:, link] & box
            stack.append(child)
    slots = torch.tensor(leaves)
    return slots, t, reach[:, slots]


@pytest.mark.parametrize("name", ["room", "building"])
def test_ties_on_a_shared_edge_go_to_the_lower_slot(name):
    """Where two or more leaves hit at the least t exactly (rays through a
    shared edge or vertex; the test asserts such rays exist) and no box
    above the lowest of their slots can prune it, the walk returns that
    slot: the walk takes the first in preorder (t < t_best is strict), and
    leaves lie in the slot table in preorder."""
    mesh, bvh = _bvh(name)
    o, d = _tie_rays(mesh)
    n = o.shape[0]
    rays = (o, d, torch.zeros(n), torch.full((n,), 3.0e38))
    leaves, t, reach = _leaves_and_reach(bvh, o, d)
    assert torch.equal(leaves, leaves.sort().values)  # preorder is slot order
    least = t.min(dim=1, keepdim=True).values
    at_least = (t == least) & torch.isfinite(least)
    lowest = torch.where(at_least, leaves[None, :], bvh.n_slots).min(dim=1).values
    first = torch.argmax(at_least.int(), dim=1)  # the column of the lowest tied slot
    ties = (at_least.sum(1) > 1) & reach[torch.arange(n), first]
    assert int(ties.sum()) >= 20
    _, slot = traverse_rays_reference(bvh.nodes, bvh.root_link, *rays)
    assert torch.equal(slot[ties], lowest[ties].to(torch.int32))


@pytest.mark.parametrize("name", ["room", "building", "sphere"])
def test_entry_rule_visits_nothing(name):
    """A ray with t_max <= t_min visits nothing: t = t_max, slot -1, no
    visits, whatever its direction."""
    mesh, bvh = _bvh(name)
    o, d, t_min, t_max = _rays(mesh, "scattered", n=600, seed=3)
    t_min[::2] = 0.5
    t_max[::4] = 0.5  # equal
    t_max[2::4] = 0.25  # inverted
    t, slot, visits = traverse_rays_reference(bvh.nodes, bvh.root_link, o, d, t_min, t_max,
                                              visits=True)
    assert torch.equal(t[::2], t_max[::2]) and bool((slot[::2] == -1).all())
    assert int(visits[::2].sum()) == 0
    assert bool((visits[1::2].sum(1) > 0).all()) and float((slot[1::2] >= 0).float().mean()) > 0.5


def test_traverse_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper runs the plain version, visits included,
    and counts no launch."""
    mesh, bvh = _bvh("room")
    rays = _rays(mesh, "scattered", n=700, seed=4)
    before = traverse_rays.launches
    got = traverse_rays(bvh.nodes, bvh.root_link, *rays, visits=True)
    want = traverse_rays_reference(bvh.nodes, bvh.root_link, *rays, visits=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert traverse_rays.launches == before


def test_cast_rays_in_chunks_equals_one_call():
    """A batch above chunk_size, walked in CPU chunks, gives what one
    unchunked call gives, bitwise."""
    mesh, bvh = _bvh("building")
    o, d, _, _ = _rays(mesh, "scattered", n=700, seed=5)
    chunked = tr.cast_rays(bvh, o, d, t_max=6.0, chunk_size=100)
    whole = tr.cast_rays(bvh, o, d, t_max=6.0)
    for f in ("t", "hit", "prim_id", "inst_id", "point", "normal"):
        assert torch.equal(getattr(chunked, f), getattr(whole, f))
    assert bool(chunked.hit.any()) and not bool(chunked.hit.all())
