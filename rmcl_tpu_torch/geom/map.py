"""Map container: mesh + acceleration structures under one handle.

Counterpart of ``rmcl_tpu.geom.map.MeshMap``. Only the triangle bins of the
dense binned engine are built: the exact BVH engine is not ported yet, so
``bvh`` stays ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from rmcl_tpu_torch.bvh.bins import TriangleBins, build_bins
from rmcl_tpu_torch.geom.mesh import TriangleMesh, load_mesh


@dataclasses.dataclass
class MeshMap:
    """A loaded map: host mesh + device acceleration structures."""

    mesh: TriangleMesh
    bvh: None
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
            bvh=None,
            bins=build_bins(mesh, bin_size=bin_size,
                            bins_per_super=bins_per_super,
                            supers_per_hyper=supers_per_hyper,
                            device=device),
            name=name or mesh.name,
        )

    @staticmethod
    def from_file(path: str, **kwargs) -> "MeshMap":
        return MeshMap.from_mesh(load_mesh(path), **kwargs)
