"""The port's engine configuration (config.py) against the JAX package's.

``to_json`` writes the same text for the same values, the defaults come from
the port's core/constants.py and equal the reference's, and a JSON written
by either package loads in the other to equal values.
"""

import json

import pytest

from octree_raymarcher_tpu import config as jax_config
from octree_raymarcher_tpu_torch import config
from octree_raymarcher_tpu_torch.core import constants

CUSTOM = dict(world=dict(dims=(2, 1, 3), chunksize=32.0, depth=6, seed=7),
              march=dict(max_steps=512, unroll=8), camera=dict(width=640, height=360),
              mesh=dict(rays=4))


def _build(mod, values):
    return mod.EngineConfig(world=mod.WorldConfig(**values.get("world", {})),
                            march=mod.MarchConfig(**values.get("march", {})),
                            camera=mod.CameraConfig(**values.get("camera", {})),
                            mesh=mod.MeshConfig(**values.get("mesh", {})))


@pytest.mark.parametrize("values", [{}, CUSTOM], ids=["default", "custom"])
def test_to_json_equals_jax(values):
    assert _build(config, values).to_json() == _build(jax_config, values).to_json()


@pytest.mark.parametrize("values", [{}, CUSTOM], ids=["default", "custom"])
def test_json_crosses_packages(values):
    port, ref = _build(config, values), _build(jax_config, values)
    from_ref = config.EngineConfig.from_json(ref.to_json())
    assert from_ref == port and hash(from_ref) == hash(port)
    from_port = jax_config.EngineConfig.from_json(port.to_json())
    assert from_port == ref
    assert json.loads(from_port.to_json()) == json.loads(from_ref.to_json())


def test_defaults_from_the_port_constants():
    cfg = config.EngineConfig()
    assert (cfg.march.max_steps, cfg.march.eps, cfg.march.bigeps) == (
        constants.MAX_STEPS, constants.EPS, constants.BIGEPS)
    assert (cfg.camera.near, cfg.camera.far) == (constants.NEAR, constants.FAR)
    assert cfg.mesh.rays == 1 and cfg.world.dims == (4, 4, 4)
