"""The plain references against tiny brute-force cases, and the frozen
world against the program's generator as it stood when it was copied."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import world
from benchmark.reference import cast as rc
from benchmark.reference import se3


def _scene():
    v, f = world.building(rooms_x=2, rooms_y=2, subdiv=3, door_t=0.5)
    return torch.from_numpy(v[f])


def _brute_cast(tri, o, d, t_min, t_max):
    F = tri.shape[0]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    t = rc._mt(o.expand(d.shape[0], F, 3), d[:, None].expand(-1, F, 3), v0.expand(d.shape[0], F, 3),
               e1.expand(d.shape[0], F, 3), e2.expand(d.shape[0], F, 3), t_min,
               t_max[:, None].expand(-1, F))
    m, a = t.min(1)
    hit = torch.isfinite(m)
    return torch.where(hit, m, rc.NO_HIT), torch.where(hit, a, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cast_matches_every_face(seed):
    tri = _scene()
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([[3.0, 3.0, 1.5], [8.5, 4.0, 0.7], [6.0, 6.0, 2.9]])
    d = torch.randn((3, 300, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.rand((3, 300), generator=g) * 8.0
    t, face = rc.cast(tri, o, d, 0.1, t_max, cells_per_chunk=4096)
    for p in range(3):
        tb, fb = _brute_cast(tri, o[p], d[p], 0.1, t_max[p])
        assert torch.equal(face[p], fb)
        assert torch.equal(t[p], tb)
    assert bool((face >= 0).any()) and bool((face < 0).any())


def test_closest_point_on_a_triangle_is_the_nearest_sample():
    g = torch.Generator().manual_seed(3)
    tri = torch.randn((200, 3, 3), generator=g)
    p = torch.randn((200, 3), generator=g) * 2.0
    cp = rc.closest_on_triangles(p, tri[:, 0], tri[:, 1], tri[:, 2])
    u = torch.linspace(0, 1, 201)
    uu, vv = torch.meshgrid(u, u, indexing="ij")
    keep = (uu + vv) <= 1
    uu, vv = uu[keep], vv[keep]
    pts = (tri[:, None, 0] + uu[None, :, None] * (tri[:, None, 1] - tri[:, None, 0])
           + vv[None, :, None] * (tri[:, None, 2] - tri[:, None, 0]))
    d_sample = (pts - p[:, None]).norm(dim=-1).min(1).values
    d_cp = (cp - p).norm(dim=-1)
    assert bool((d_cp <= d_sample + 1e-5).all())
    assert bool((d_sample - d_cp).max() < 0.05)


def test_closest_matches_every_face():
    tri = _scene()
    g = torch.Generator().manual_seed(4)
    q = torch.rand((500, 3), generator=g) * torch.tensor([12.0, 12.0, 3.0])
    point, face, dist = rc.closest(tri, q, 0.5, pairs_per_chunk=5000)
    cp = rc.closest_on_triangles(q[:, None], tri[None, :, 0], tri[None, :, 1], tri[None, :, 2])
    d = (cp - q[:, None]).norm(dim=-1)
    best = d.min(1).values
    inside = best <= 0.5
    assert torch.equal(face >= 0, inside)
    assert torch.allclose(dist[inside], best[inside], atol=1e-6)
    assert torch.allclose(point[inside], cp[inside, face[inside]], atol=1e-6)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.14159265, 1e-20])
    y = se3.tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2**-10
    assert bool(((y.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((y - x).abs() <= x.abs() * 2**-11).all())


def test_frozen_world_equals_the_program_generator():
    from rmcl_tpu_torch.geom.mesh import make_building_scene

    v, f = world.building(subdiv=3)
    mesh = make_building_scene(subdiv=3, seed=0, door_t=0.5)
    assert np.array_equal(v, mesh.vertices) and np.array_equal(f, mesh.faces)


def test_rays_and_rotations_match_the_program():
    from rmcl_tpu_torch.math.se3 import Quaternion
    from rmcl_tpu_torch.sensors.models import SphericalModel

    spec = dict(width=900, height=16, theta_min=-3.14159265, theta_max=3.14159265,
                phi_min=-0.2617994, phi_max=0.2617994)
    _, d = SphericalModel.vlp16().rays("cpu")
    assert np.allclose(world.spherical_dirs(spec), d.numpy(), atol=1e-6)
    e = torch.tensor([[0.1, -0.2, 2.5], [1.0, 0.3, -1.2]])
    q = Quaternion.from_euler(e[:, 0], e[:, 1], e[:, 2])
    r = se3.euler(e[:, 0], e[:, 1], e[:, 2])
    assert torch.allclose(se3.quat_matrix(q), r, atol=1e-6)
    back = torch.stack(se3.to_euler(r), -1)
    assert torch.allclose(back, e, atol=1e-5)
