"""Map container: mesh + acceleration structures under one handle.

Counterpart of ``rmcl_tpu.geom.map``: ``MeshMap`` and the name→map registry
``MapContainer``. One map carries both device structures, so a pipeline
picks the engine per query type:

  * ``bvh``  — threaded BVH for exact traversal and closest-point queries
  * ``bins`` — triangle bins for the dense binned engine
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from rmcl_tpu_torch.bvh.bins import TriangleBins, build_bins
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.bvh.types import BVH
from rmcl_tpu_torch.geom.mesh import TriangleMesh, load_mesh


@dataclasses.dataclass
class MeshMap:
    """A loaded map: host mesh + device acceleration structures."""

    mesh: TriangleMesh
    bvh: BVH
    bins: TriangleBins
    name: str = "map"

    @staticmethod
    def from_mesh(
        mesh: TriangleMesh,
        name: Optional[str] = None,
        bin_size: Optional[int] = None,
        bins_per_super: int = 64,
        supers_per_hyper: int = 8,
        device="cuda",
    ) -> "MeshMap":
        if bin_size is None:
            # bin size scales with tessellation so a ray block's candidate
            # budget keeps covering its footprint: 64 @ <=2M faces, 128 @
            # <=4M, 256 @ <=8M, 512 above
            f = mesh.n_faces
            bin_size = 64
            while f > 2_000_000 and bin_size < 512:
                bin_size *= 2
                f //= 2
        return MeshMap(
            mesh=mesh,
            bvh=build_bvh(mesh, device=device),
            bins=build_bins(mesh, bin_size=bin_size,
                            bins_per_super=bins_per_super,
                            supers_per_hyper=supers_per_hyper,
                            device=device),
            name=name or mesh.name,
        )

    @staticmethod
    def from_file(path: str, **kwargs) -> "MeshMap":
        return MeshMap.from_mesh(load_mesh(path), **kwargs)


class MapContainer:
    """Name→map registry shared between pipelines (counterpart of
    ``rmcl_tpu.geom.map.MapContainer``): one entry serves every engine. Every
    map it loads lives on ``device``."""

    def __init__(self, device="cuda") -> None:
        self.device = device
        self._maps: Dict[str, MeshMap] = {}

    def load(self, name: str, path_or_mesh) -> MeshMap:
        if name not in self._maps:
            if isinstance(path_or_mesh, TriangleMesh):
                self._maps[name] = MeshMap.from_mesh(path_or_mesh, name=name,
                                                     device=self.device)
            else:
                self._maps[name] = MeshMap.from_file(path_or_mesh, name=name,
                                                     device=self.device)
        return self._maps[name]

    def get(self, name: str) -> MeshMap:
        return self._maps[name]

    def __contains__(self, name: str) -> bool:
        return name in self._maps
