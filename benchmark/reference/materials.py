"""Material table: per-material-id ambient/diffuse/specular/shininess.

PyTorch counterpart of octree_raymarcher_tpu/shade/materials.py (the
reference's 8-entry GLSL table, shaders/World.Fragment.glsl:63-73).  The
lookup is a plain row index; the reference's one-hot matmul was a TPU
workaround for slow row gathers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Distinct base colors per material so unlit/albedo renders are informative
# (the reference gets color variety from a PNG texture atlas instead).
_DEFAULT_TABLE = [
    # name      ambient        diffuse                  specular          shininess
    ("void",   (0, 0, 0),     (0.0, 0.0, 0.0),         (0.0, 0.0, 0.0),  1.0),
    ("stone",  (0.8,) * 3,    (0.55, 0.55, 0.58),      (0.5,) * 3,       8.0),
    ("dirt",   (0.8,) * 3,    (0.45, 0.32, 0.18),      (0.1,) * 3,       16.0),
    ("sand",   (0.8,) * 3,    (0.86, 0.78, 0.55),      (0.15,) * 3,      32.0),
    ("grass",  (0.8,) * 3,    (0.25, 0.60, 0.20),      (0.7,) * 3,       1000.0),
    ("shroom", (0.8,) * 3,    (0.62, 0.30, 0.45),      (0.0,) * 3,       1.0),
    ("water",  (0.8,) * 3,    (0.15, 0.35, 0.70),      (1.0,) * 3,       100.0),
    ("void2",  (0, 0, 0),     (0.0, 0.0, 0.0),         (0.0, 0.0, 0.0),  1.0),
]

MATERIAL_NAMES = [row[0] for row in _DEFAULT_TABLE]
NUM_MATERIALS = len(_DEFAULT_TABLE)


@dataclasses.dataclass
class MaterialTable:
    ambient: torch.Tensor     # f32[M, 3]
    diffuse: torch.Tensor     # f32[M, 3]
    specular: torch.Tensor    # f32[M, 3]
    shininess: torch.Tensor   # f32[M]

    @staticmethod
    def default(device="cpu") -> "MaterialTable":
        cols = [np.array([r[k] for r in _DEFAULT_TABLE], np.float32) for k in (1, 2, 3, 4)]
        return MaterialTable(*(torch.from_numpy(c).to(device) for c in cols))

    @staticmethod
    def from_numpy(obj, device="cpu", requires_grad: bool = False) -> "MaterialTable":
        """From any object with ambient/diffuse/specular/shininess arrays
        (for example the JAX package's MaterialTable), each column a
        float32 tensor on ``device`` that requires grad when
        ``requires_grad``."""
        return MaterialTable(*(
            torch.from_numpy(np.array(getattr(obj, k), dtype=np.float32)).to(device)
            .requires_grad_(requires_grad)
            for k in ("ambient", "diffuse", "specular", "shininess")
        ))

    @property
    def requires_grad(self) -> bool:
        return any(c.requires_grad for c in (self.ambient, self.diffuse, self.specular,
                                               self.shininess))

    @property
    def num_materials(self) -> int:
        return self.ambient.shape[0]

    def to(self, device) -> "MaterialTable":
        return MaterialTable(self.ambient.to(device), self.diffuse.to(device),
                             self.specular.to(device), self.shininess.to(device))

    def to_matrix(self) -> torch.Tensor:
        """f32[M, 10] rows (ambient 3, diffuse 3, specular 3, shininess), the
        layout of the shading kernel."""
        return torch.cat([self.ambient, self.diffuse, self.specular,
                          self.shininess[:, None]], dim=1).contiguous()

    def lookup(self, material_id):
        """Per-ray material params; ids are clipped to the table, and id 0
        (and misses) give black.  A plain row index, so a table that
        requires grad gets its gradient summed into the rows here, with no
        host copy."""
        m = material_id.clamp(0, self.num_materials - 1).long()
        return self.ambient[m], self.diffuse[m], self.specular[m], self.shininess[m]


__all__ = ["MaterialTable", "MATERIAL_NAMES", "NUM_MATERIALS"]
