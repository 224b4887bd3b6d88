"""Rigid transforms as plain 4 x 4 matrices, and the few rotation maps the
references need. Quaternions are [w, x, y, z]; Euler angles are
Rz(yaw) Ry(pitch) Rx(roll)."""

from __future__ import annotations

import dataclasses

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), as a tensor core
    takes a float32 operand."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """The references' arithmetic: float32 with exact matrix products (the
    configurations'), or the control below it: matrix products on TF32
    operands."""

    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return tf32(a) @ tf32(b)
        return a.float() @ b.float()


FLOAT32 = Precision()
TF32 = Precision(tf32=True)


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) of quaternions (..., 4) [w, x, y, z]
    (normalised first)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from rotations (..., 3, 3) and translations (..., 3)."""
    m = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    return m


def from_quat(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return matrix(quat_matrix(q), t)


def euler(roll, pitch, yaw) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) of Euler angles."""
    cr, sr, cp, sp = torch.cos(roll), torch.sin(roll), torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def to_euler(r: torch.Tensor):
    """(roll, pitch, yaw) of rotation matrices (..., 3, 3)."""
    roll = torch.atan2(r[..., 2, 1], r[..., 2, 2])
    pitch = torch.asin(torch.clamp(-r[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(r[..., 1, 0], r[..., 0, 0])
    return roll, pitch, yaw


def exp_so3(w: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
    """Rodrigues: the rotation (..., 3, 3) of rotation vectors (..., 3)."""
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    k = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    k[..., 0, 1], k[..., 0, 2], k[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    k[..., 1, 0], k[..., 2, 0], k[..., 2, 1] = w[..., 2], -w[..., 1], w[..., 0]
    small = theta < 1e-8
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta ** 2 / 24.0, (1.0 - torch.cos(safe)) / safe ** 2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(k)
    return eye + a * k + b * prec.mm(k, k).to(k.dtype)


def inverse(m: torch.Tensor) -> torch.Tensor:
    r = m[..., :3, :3].transpose(-1, -2)
    return matrix(r, -(r @ m[..., :3, 3:4])[..., 0])


def apply(m: torch.Tensor, p: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
    """Points (..., 3) through a transform (4, 4)."""
    return prec.mm(p, m[:3, :3].transpose(0, 1)).float() + m[:3, 3]


def rotate(m: torch.Tensor, v: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
    return prec.mm(v, m[:3, :3].transpose(0, 1)).float()


def rotation_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle (rad) of a^-1 b between rotation matrices (..., 3, 3),
    taken in float64."""
    r = a.double().transpose(-1, -2) @ b.double()
    c = (r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    s = torch.linalg.norm(torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                                       r[..., 1, 0] - r[..., 0, 1]], -1), dim=-1) / 2.0
    return torch.atan2(s, c)
