"""Engine configuration: one frozen dataclass tree, serializable to JSON.

PyTorch counterpart of octree_raymarcher_tpu/config.py (the reference's
compile-time constants gathered in one place: world dims, TREE_MAX_DEPTH and
PYRAMID_RESOLUTION, the march caps and EPS, NEAR/FAR).  The defaults come
from the port's own core/constants.py, and ``to_json`` writes the same text
the JAX package's does for the same values, so a file written by either
loads in the other.  ``MeshConfig.rays`` is the number of ranks of the
port's ray-sharded group (parallel/).
"""

from __future__ import annotations

import dataclasses
import json

from .core import constants


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    dims: tuple = (4, 4, 4)
    chunksize: float = 128.0
    depth: int = 8
    seed: int = 0
    water_level: float = 6.0
    amplitude: float = 64.0
    pyramid_resolution: int = 256


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    max_steps: int = constants.MAX_STEPS
    unroll: int = 4
    tile: int = 32768
    eps: float = constants.EPS
    bigeps: float = constants.BIGEPS


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 1920
    height: int = 1080
    fov_deg: float = 80.0
    near: float = constants.NEAR
    far: float = constants.FAR


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The ray-sharded group (parallel/mesh.py): ``rays`` ranks, each
    taking a contiguous slice of the rays; 1 is a single process."""
    rays: int = 1


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    world: WorldConfig = WorldConfig()
    march: MarchConfig = MarchConfig()
    camera: CameraConfig = CameraConfig()
    mesh: MeshConfig = MeshConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "EngineConfig":
        d = json.loads(text)
        return EngineConfig(
            world=WorldConfig(**{**d.get("world", {}),
                                 "dims": tuple(d.get("world", {}).get("dims", (4, 4, 4)))}),
            march=MarchConfig(**d.get("march", {})),
            camera=CameraConfig(**d.get("camera", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
        )


__all__ = ["EngineConfig", "WorldConfig", "MarchConfig", "CameraConfig", "MeshConfig"]
