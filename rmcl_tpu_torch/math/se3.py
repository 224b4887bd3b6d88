"""SE(3) rigid transforms on torch tensors.

Counterpart of ``rmcl_tpu.math.se3``. A ``Transform`` is a frozen dataclass
of two tensors — ``rot`` (..., 4) unit quaternion stored **[w, x, y, z]**
and ``trans`` (..., 3) — and every operation broadcasts over leading batch
dimensions.

Conventions (as in the JAX package):
  * ``a @ b`` means "apply ``b`` first, then ``a``";
  * ``T.apply(p)`` maps points from the source frame into the target frame;
  * Euler angles are intrinsic roll(x)-pitch(y)-yaw(z), composed as
    ``Rz(yaw) @ Ry(pitch) @ Rx(roll)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rmcl_tpu_torch._device import resolve_device

Tensor = torch.Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


class Quaternion:
    """Namespace of unit-quaternion ops on (..., 4) tensors in [w,x,y,z]."""

    @staticmethod
    def identity(batch_shape: Tuple[int, ...] = (), device="cuda",
                 dtype=torch.float32) -> Tensor:
        q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype,
                        device=resolve_device(device))
        q[..., 0] = 1.0
        return q

    @staticmethod
    def mul(a: Tensor, b: Tensor) -> Tensor:
        aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return torch.stack(
            [
                aw * bw - ax * bx - ay * by - az * bz,
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw,
            ],
            dim=-1,
        )

    @staticmethod
    def conj(q: Tensor) -> Tensor:
        return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])

    @staticmethod
    def normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
        n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
        return q / torch.clamp(n, min=eps)

    @staticmethod
    def rotate(q: Tensor, v: Tensor) -> Tensor:
        """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
        qw = q[..., :1]
        qv = q[..., 1:]
        # v' = v + 2 qv x (qv x v + qw v)
        t = 2.0 * _cross(qv, v)
        return v + qw * t + _cross(qv, t)

    @staticmethod
    def from_euler(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
        """Rz(yaw) Ry(pitch) Rx(roll), matching rmagine EulerAngles."""
        cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
        cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
        cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
        return torch.stack(
            [
                cy * cp * cr + sy * sp * sr,
                cy * cp * sr - sy * sp * cr,
                cy * sp * cr + sy * cp * sr,
                sy * cp * cr - cy * sp * sr,
            ],
            dim=-1,
        )

    @staticmethod
    def to_euler(q: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
        pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
        yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
        return roll, pitch, yaw

    @staticmethod
    def to_matrix(q: Tensor) -> Tensor:
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        rows = [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ]
        return torch.stack(rows, dim=-2)

    @staticmethod
    def from_matrix(m: Tensor) -> Tensor:
        """Robust (Shepperd) rotation-matrix → quaternion, branch-free."""
        m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        tr = m00 + m11 + m22
        # four candidate quaternions, pick the numerically best per element
        qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
        qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
        qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
        qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
        cases = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
        scores = torch.stack(
            [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
        )
        best = torch.argmax(scores, dim=-1)  # first maximum, like jnp.argmax
        idx = best[..., None, None].expand(best.shape + (1, 4))
        q = torch.gather(cases, -2, idx)[..., 0, :]
        q = Quaternion.normalize(q)
        # canonical sign: w >= 0
        return q * torch.where(q[..., :1] < 0, -1.0, 1.0)

    @staticmethod
    def log(q: Tensor) -> Tensor:
        """Rotation-vector (axis*angle) log map, (...,4) → (...,3)."""
        q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
        w = torch.clamp(q[..., 0], -1.0, 1.0)
        v = q[..., 1:]
        vn = torch.sqrt(torch.sum(v * v, dim=-1))
        angle = 2.0 * torch.atan2(vn, w)
        small = vn < 1e-9
        scale = torch.where(small, 2.0, angle / torch.where(small, 1.0, vn))
        return v * scale[..., None]

    @staticmethod
    def exp(v: Tensor) -> Tensor:
        """Rotation-vector exp map, (...,3) → (...,4); finite gradient at 0."""
        sum_sq = torch.sum(v * v, dim=-1, keepdim=True)
        angle = torch.sqrt(torch.clamp(sum_sq, min=1e-24))
        half = 0.5 * angle
        small = sum_sq < 1e-18
        k = torch.where(small, 0.5 - sum_sq / 48.0, torch.sin(half) / angle)
        return torch.cat([torch.cos(half), v * k], dim=-1)


@dataclasses.dataclass(frozen=True)
class EulerAngles:
    roll: Tensor
    pitch: Tensor
    yaw: Tensor

    def to_quaternion(self) -> Tensor:
        return Quaternion.from_euler(self.roll, self.pitch, self.yaw)


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rigid transform: rotation quaternion [w,x,y,z] + translation."""

    rot: Tensor  # (..., 4)
    trans: Tensor  # (..., 3)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def identity(batch_shape: Tuple[int, ...] = (), device="cuda",
                 dtype=torch.float32) -> "Transform":
        dev = resolve_device(device)
        return Transform(
            rot=Quaternion.identity(batch_shape, dev, dtype),
            trans=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=dev),
        )

    @staticmethod
    def from_xyz_euler(xyz: Tensor, euler: Tensor) -> "Transform":
        """From 6-vector blocks: xyz (...,3) translation, euler (...,3) rpy."""
        return Transform(
            rot=Quaternion.from_euler(euler[..., 0], euler[..., 1], euler[..., 2]),
            trans=xyz,
        )

    @staticmethod
    def from_pose_tuple(pose, device="cuda") -> "Transform":
        """From the reference's 6-tuple (x,y,z,roll,pitch,yaw) or 7-tuple
        (x,y,z,qx,qy,qz,qw) ``initial_pose_guess`` format."""
        pose = torch.as_tensor(pose, dtype=torch.float32,
                               device=resolve_device(device))
        if pose.shape[-1] == 6:
            return Transform.from_xyz_euler(pose[..., :3], pose[..., 3:])
        if pose.shape[-1] == 7:
            q_xyzw = pose[..., 3:]
            q = torch.cat([q_xyzw[..., 3:4], q_xyzw[..., 0:3]], dim=-1)
            return Transform(rot=Quaternion.normalize(q), trans=pose[..., :3])
        raise ValueError(f"pose tuple must have 6 or 7 entries, got {tuple(pose.shape)}")

    @staticmethod
    def from_matrix(m: Tensor) -> "Transform":
        return Transform(rot=Quaternion.from_matrix(m[..., :3, :3]), trans=m[..., :3, 3])

    # -- core algebra -------------------------------------------------------

    def compose(self, other: "Transform") -> "Transform":
        """self ∘ other — apply ``other`` first."""
        return Transform(
            rot=Quaternion.mul(self.rot, other.rot),
            trans=Quaternion.rotate(self.rot, other.trans) + self.trans,
        )

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    def inverse(self) -> "Transform":
        rinv = Quaternion.conj(self.rot)
        return Transform(rot=rinv, trans=-Quaternion.rotate(rinv, self.trans))

    def __invert__(self) -> "Transform":
        return self.inverse()

    def apply(self, points: Tensor) -> Tensor:
        """Transform points (..., 3). Broadcasts batch dims."""
        return Quaternion.rotate(self.rot, points) + self.trans

    def rotate(self, vectors: Tensor) -> Tensor:
        """Rotate direction vectors (no translation)."""
        return Quaternion.rotate(self.rot, vectors)

    def normalized(self) -> "Transform":
        """Re-normalize the quaternion."""
        return Transform(rot=Quaternion.normalize(self.rot), trans=self.trans)

    # -- conversions --------------------------------------------------------

    def to_matrix(self) -> Tensor:
        rot = Quaternion.to_matrix(self.rot)
        top = torch.cat([rot, self.trans[..., :, None]], dim=-1)
        bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def log6(self) -> Tensor:
        """6-vector [t, rotvec]."""
        return torch.cat([self.trans, Quaternion.log(self.rot)], dim=-1)

    # -- misc ---------------------------------------------------------------

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.trans.shape[:-1])

    def is_finite(self) -> Tensor:
        """NaN guard (reference ``check(Transform)``)."""
        return (torch.isfinite(self.rot).all(dim=-1)
                & torch.isfinite(self.trans).all(dim=-1))

    def __getitem__(self, idx) -> "Transform":
        return Transform(rot=self.rot[idx], trans=self.trans[idx])

    def expand_dims(self, axis: int = -1) -> "Transform":
        """Insert a new batch axis (axis counts within the batch dims)."""
        a = axis if axis >= 0 else axis - 1
        return Transform(rot=self.rot.unsqueeze(a), trans=self.trans.unsqueeze(a))

    def reshape(self, batch_shape: Tuple[int, ...]) -> "Transform":
        return Transform(
            rot=self.rot.reshape(tuple(batch_shape) + (4,)),
            trans=self.trans.reshape(tuple(batch_shape) + (3,)),
        )
