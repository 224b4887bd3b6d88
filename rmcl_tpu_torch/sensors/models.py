"""Sensor models as ray generators.

Counterpart of ``rmcl_tpu.sensors.models``. Each model is a frozen
dataclass; ``rays(device)`` produces the full (origins, directions) bundle
in the sensor frame, in the reference's row-major pixel order
(``id = v * width + u``). Scalar parameters are held as Python floats
rounded to float32, so that the rays equal the JAX package's, which keeps
them as float32 scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from rmcl_tpu_torch._device import resolve_device

Tensor = torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class RangeInterval:
    """Min/max valid range."""

    min: float
    max: float

    @staticmethod
    def of(lo: float, hi: float) -> "RangeInterval":
        return RangeInterval(_f32(lo), _f32(hi))

    def contains(self, r: Tensor) -> Tensor:
        return (r >= self.min) & (r <= self.max)


@dataclasses.dataclass(frozen=True)
class SphericalModel:
    """Rotating LiDAR grid: ``width`` azimuth steps x ``height`` elevation
    steps."""

    theta_min: float  # horizontal / azimuth start (rad) — width axis
    theta_inc: float
    phi_min: float  # vertical / elevation start — height axis
    phi_inc: float
    range: RangeInterval
    width: int
    height: int

    @staticmethod
    def create(
        width: int,
        height: int,
        theta_min: float = -3.14159265,
        theta_max: float = 3.14159265,
        phi_min: float = -0.2617994,  # -15 deg (VLP-16)
        phi_max: float = 0.2617994,
        range_min: float = 0.1,
        range_max: float = 130.0,
        theta_endpoint: bool = False,
        phi_endpoint: bool = True,
    ) -> "SphericalModel":
        theta_inc = (theta_max - theta_min) / (
            width - 1 if theta_endpoint and width > 1 else width
        )
        phi_inc = (
            (phi_max - phi_min) / (height - 1 if phi_endpoint and height > 1 else height)
            if height > 1
            else 0.0
        )
        return SphericalModel(
            theta_min=_f32(theta_min),
            theta_inc=_f32(theta_inc),
            phi_min=_f32(phi_min),
            phi_inc=_f32(phi_inc),
            range=RangeInterval.of(range_min, range_max),
            width=width,
            height=height,
        )

    @staticmethod
    def vlp16(width: int = 900) -> "SphericalModel":
        """The reference benchmark's Velodyne VLP-16 model (900x16)."""
        return SphericalModel.create(width=width, height=16)

    @property
    def n_rays(self) -> int:
        return self.width * self.height

    def angles(self, device="cuda") -> Tuple[Tensor, Tensor]:
        """(theta[width] azimuth, phi[height] elevation) grids."""
        dev = resolve_device(device)
        w = torch.arange(self.width, dtype=torch.float32, device=dev)
        h = torch.arange(self.height, dtype=torch.float32, device=dev)
        return self.theta_min + w * self.theta_inc, self.phi_min + h * self.phi_inc

    def rays(self, device="cuda") -> Tuple[Tensor, Tensor]:
        """Sensor-frame ray bundle: origins (N,3) zeros, dirs (N,3)."""
        theta, phi = self.angles(device)
        az = theta[None, :]  # (1, W)
        el = phi[:, None]  # (H, 1)
        ce = torch.cos(el)
        shape = (self.height, self.width)
        dirs = torch.stack(
            [
                (ce * torch.cos(az)).expand(shape),
                (ce * torch.sin(az)).expand(shape),
                (torch.sin(el) * torch.ones_like(az)).expand(shape),
            ],
            dim=-1,
        ).reshape(-1, 3)
        return torch.zeros_like(dirs), dirs

    def polar_to_cartesian(self, ranges: Tensor) -> Tensor:
        _, dirs = self.rays(ranges.device)
        return dirs * ranges[..., None]


@dataclasses.dataclass(frozen=True)
class PinholeModel:
    """Depth camera intrinsics. Camera convention: z forward, x right,
    y down."""

    fx: float
    fy: float
    cx: float
    cy: float
    range: RangeInterval
    width: int
    height: int

    @staticmethod
    def create(width: int, height: int, fx: float, fy: float, cx: float, cy: float,
               range_min: float = 0.3, range_max: float = 8.0) -> "PinholeModel":
        return PinholeModel(
            fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
            range=RangeInterval.of(range_min, range_max),
            width=width, height=height,
        )

    @property
    def n_rays(self) -> int:
        return self.width * self.height

    def rays(self, device="cuda") -> Tuple[Tensor, Tensor]:
        dev = resolve_device(device)
        u = torch.arange(self.width, dtype=torch.float32, device=dev)[None, :]
        v = torch.arange(self.height, dtype=torch.float32, device=dev)[:, None]
        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        shape = (self.height, self.width)
        dirs = torch.stack(
            [x.expand(shape), y.expand(shape),
             torch.ones(shape, dtype=torch.float32, device=dev)],
            dim=-1,
        )
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
        return torch.zeros((self.n_rays, 3), dtype=torch.float32, device=dev), dirs.reshape(-1, 3)


@dataclasses.dataclass(frozen=True)
class O1DnModel:
    """One origin, N arbitrary directions — generic LiDAR."""

    orig: Tensor  # (3,)
    dirs: Tensor  # (N, 3)
    range: RangeInterval

    @staticmethod
    def create(dirs, orig=None, range_min: float = 0.0, range_max: float = 1e3,
               device="cuda") -> "O1DnModel":
        dev = resolve_device(device)
        dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
        orig = (torch.zeros(3, dtype=torch.float32, device=dev) if orig is None
                else torch.as_tensor(orig, dtype=torch.float32, device=dev))
        return O1DnModel(orig=orig, dirs=dirs,
                         range=RangeInterval.of(range_min, range_max))

    @property
    def n_rays(self) -> int:
        return self.dirs.shape[0]

    def rays(self, device=None) -> Tuple[Tensor, Tensor]:
        """The model's own tensors; ``device`` (if given) moves them."""
        o, d = self.orig.expand(self.dirs.shape), self.dirs
        if device is not None:
            dev = resolve_device(device)
            o, d = o.to(dev), d.to(dev)
        return o, d

    def polar_to_cartesian(self, ranges: Tensor) -> Tensor:
        return self.orig + self.dirs * ranges[..., None]


@dataclasses.dataclass(frozen=True)
class OnDnModel:
    """N origins, N directions — fully generic."""

    origs: Tensor  # (N, 3)
    dirs: Tensor  # (N, 3)
    range: RangeInterval

    @staticmethod
    def create(origs, dirs, range_min: float = 0.0, range_max: float = 1e3,
               device="cuda") -> "OnDnModel":
        dev = resolve_device(device)
        return OnDnModel(
            origs=torch.as_tensor(origs, dtype=torch.float32, device=dev),
            dirs=torch.as_tensor(dirs, dtype=torch.float32, device=dev),
            range=RangeInterval.of(range_min, range_max),
        )

    @property
    def n_rays(self) -> int:
        return self.dirs.shape[0]

    def rays(self, device=None) -> Tuple[Tensor, Tensor]:
        """The model's own tensors; ``device`` (if given) moves them."""
        o, d = self.origs, self.dirs
        if device is not None:
            dev = resolve_device(device)
            o, d = o.to(dev), d.to(dev)
        return o, d

    def polar_to_cartesian(self, ranges: Tensor) -> Tensor:
        return self.origs + self.dirs * ranges[..., None]


SensorModel = SphericalModel | PinholeModel | O1DnModel | OnDnModel
