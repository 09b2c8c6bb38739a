"""The shading kernel K2's plain version and the host packing of its
parameter block, against the JAX package, on the CPU.

* ``shade_hits_plain`` against the JAX ``shade_hits``
  (octree_raymarcher_tpu/shade/render.py:62) on a batch of whole 32-ray
  warps that are all hit, all miss and mixed (``test_torch_scenes.
  shade_batch``: hit points on cell faces, material ids 0, the last row, ids
  past the table and negative ones), untextured and with an atlas of fewer
  tiles than the table has materials plus a sky map, with and without a
  shadow factor, under a light rig and a material table other than the
  defaults.  Tolerance: rgb, depth, point and normal at rtol 1e-5 / atol
  1e-5, as the render parity of tests/test_torch_render.py (XLA may contract
  a multiply-add that eager PyTorch rounds twice, and grass shininess 1000
  magnifies an ulp of the specular base); hit and material exact.
* ``shade_tables``, the host block K2's parameters are packed from, against
  ``LightRig.to_vector`` and ``MaterialTable.to_matrix``, against the JAX
  package's ``LightRig`` and ``MaterialTable`` carried across by
  ``from_numpy``, and against the slots csrc/shade.cuh declares; an empty
  table raises, a full one is never cut short.
* ``shade_hits`` with material tables of 40 and 300 rows (more than the
  block holds; K2 takes them by pointer) against the JAX ``shade_hits``,
  ids spread over the table and past both ends.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.ops.march_jnp import MarchResult as JaxMarchResult
from octree_raymarcher_tpu.shade.lights import LightRig as JaxLightRig
from octree_raymarcher_tpu.shade.materials import MaterialTable as JaxMaterialTable
from octree_raymarcher_tpu.shade.render import RenderConfig as JaxRenderConfig
from octree_raymarcher_tpu.shade.render import shade_hits as jax_shade_hits
from octree_raymarcher_tpu_torch import kernels
from octree_raymarcher_tpu_torch.ops.march import MarchResult
from octree_raymarcher_tpu_torch.shade import default_atlas, default_envmap
from octree_raymarcher_tpu_torch.shade.lights import VECTOR_LAYOUT, LightRig
from octree_raymarcher_tpu_torch.shade.materials import MaterialTable
from octree_raymarcher_tpu_torch.shade.render import (
    BLOCK_EYE,
    BLOCK_LIGHTS,
    BLOCK_ROWS,
    BLOCK_SKY,
    MATERIAL_ROW,
    SHADE_MAX_MATERIALS,
    RenderConfig,
    shade_hits,
    shade_hits_plain,
    shade_tables,
)

from test_torch_scenes import shade_batch, warp_kinds

RTOL = ATOL = 1e-5
SKY = (0.1, 0.2, 0.3)


def _jax_rig():
    rig = JaxLightRig.default()
    return rig.replace(point=rig.point.replace(position=np.float32([3.0, 9.0, -4.0]),
                                               linear=0.05),
                       spot=rig.spot.replace(position=np.float32([-2.0, 12.0, 5.0]),
                                             cos_gamma=np.float32(0.7)))


def _jax_table():
    t = JaxMaterialTable.default()
    return t.replace(shininess=t.shininess.at[2].set(64.0),
                     diffuse=t.diffuse.at[7].set(jnp.float32([0.3, 0.2, 0.1])))


def _table(rows: int) -> MaterialTable:
    rng = np.random.default_rng(rows)
    cols = [rng.uniform(0, 1, (rows, 3)), rng.uniform(0, 1, (rows, 3)),
            rng.uniform(0, 1, (rows, 3)), rng.uniform(1, 100, rows)]
    return MaterialTable(*(torch.from_numpy(c.astype(np.float32)) for c in cols))


@pytest.mark.parametrize("shadowed", [False, True], ids=["lit", "shadow_factor"])
@pytest.mark.parametrize("textured", [False, True], ids=["plain", "atlas5_env"])
def test_shade_hits_plain_matches_jax_on_warp_groups(textured, shadowed):
    res, o, d, eye = shade_batch()
    kinds = warp_kinds(res["hit"])
    assert min(kinds.values()) >= 4, kinds
    rng = np.random.default_rng(11)
    shadow = (rng.uniform(size=len(o)) < 0.3).astype(np.float32) if shadowed else None
    tex = {}
    if textured:
        atlas = default_atlas(resolution=16, seed=0)[:5]     # 5 tiles for 8 materials
        tex = {"atlas": atlas, "envmap": default_envmap(32, 64)}
    jrig, jmat = _jax_rig(), _jax_table()
    ref = jax_shade_hits(JaxMarchResult(**{k: jnp.asarray(v) for k, v in res.items()}),
                         o, d, jnp.asarray(eye), jrig, jmat, JaxRenderConfig(sky=SKY),
                         shadow_factor=None if shadow is None else jnp.asarray(shadow),
                         **{k: jnp.asarray(v) for k, v in tex.items()})
    got = shade_hits_plain(MarchResult(**{k: torch.from_numpy(v) for k, v in res.items()}),
                           torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(eye),
                           LightRig.from_numpy(jrig), MaterialTable.from_numpy(jmat),
                           RenderConfig(sky=SKY),
                           shadow_factor=None if shadow is None else torch.from_numpy(shadow),
                           **{k: torch.from_numpy(v) for k, v in tex.items()})
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(got["material"].numpy(), np.asarray(ref["material"]))
    for k in ("rgb", "depth", "point", "normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    miss = ~res["hit"]
    if not textured:
        np.testing.assert_array_equal(got["rgb"].numpy()[miss], np.float32([SKY] * miss.sum()))
    assert (got["depth"].numpy()[miss] == 1.0).all()
    lit = got["rgb"].numpy()[res["hit"] & (res["material"] > 0) & (res["material"] < 7)]
    assert (lit > 0).any()


def test_shade_tables_pack_the_rig_and_the_table():
    """A host eye and a host table travel in the block: the eye, the sky,
    LightRig.to_vector, then MaterialTable.to_matrix row by row."""
    rig, mats = LightRig.default(), MaterialTable.default()
    cfg = RenderConfig(sky=SKY)
    for eye in (np.float32([1.5, -2.0, 3.25]), torch.tensor([1.5, -2.0, 3.25]), (1.5, -2.0, 3.25)):
        t = shade_tables(eye, rig, mats, cfg, "cpu")
        assert t.eye is None and t.columns is None and t.num_materials == 8
        assert t.block.dtype == np.float32 and t.block.shape == (BLOCK_ROWS + 8 * MATERIAL_ROW,)
        np.testing.assert_array_equal(t.block[BLOCK_EYE:BLOCK_EYE + 3], [1.5, -2.0, 3.25])
        np.testing.assert_array_equal(t.block[BLOCK_SKY:BLOCK_SKY + 3], np.float32(SKY))
        np.testing.assert_array_equal(t.block[BLOCK_LIGHTS:BLOCK_ROWS], rig.to_vector())
        np.testing.assert_array_equal(t.block[BLOCK_ROWS:],
                                      mats.to_matrix().numpy().reshape(-1))


def test_shade_tables_from_jax_tables():
    """The JAX package's rig and table, carried across by from_numpy, land
    in the block field by field in the kernel's layout."""
    jrig, jmat = _jax_rig(), _jax_table()
    t = shade_tables(np.zeros(3, np.float32), LightRig.from_numpy(jrig),
                     MaterialTable.from_numpy(jmat), RenderConfig(), "cpu")
    want = np.concatenate([np.asarray(getattr(getattr(jrig, lt), f), np.float32).reshape(w)
                           for lt, f, w in VECTOR_LAYOUT])
    np.testing.assert_array_equal(t.block[BLOCK_LIGHTS:BLOCK_ROWS], want)
    rows = np.concatenate([np.asarray(jmat.ambient), np.asarray(jmat.diffuse),
                           np.asarray(jmat.specular), np.asarray(jmat.shininess)[:, None]],
                          axis=1).astype(np.float32)
    np.testing.assert_array_equal(t.block[BLOCK_ROWS:].reshape(-1, MATERIAL_ROW), rows)


def test_shade_block_slots_match_the_kernel():
    """The block offsets and the row capacity the wrapper packs by are the
    ones csrc/shade.cuh declares for K2 and K8."""
    src = (kernels.CSRC / "shade.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"(kBlock\w+|kMaxMaterials|kLightFloats)"
                                               r" = (\d+)", src)}
    assert consts == {"kBlockEye": BLOCK_EYE, "kBlockSky": BLOCK_SKY,
                      "kBlockLights": BLOCK_LIGHTS, "kBlockRows": BLOCK_ROWS,
                      "kMaxMaterials": SHADE_MAX_MATERIALS,
                      "kLightFloats": BLOCK_ROWS - BLOCK_LIGHTS}
    assert LightRig.default().to_vector().shape == (BLOCK_ROWS - BLOCK_LIGHTS,)
    assert MaterialTable.default().to_matrix().shape[1] == MATERIAL_ROW


@pytest.mark.parametrize("rows", [0])
def test_shade_tables_refuse_a_table_too_large(rows):
    with pytest.raises(ValueError, match="at least 1 row"):
        shade_tables(np.zeros(3, np.float32), LightRig.default(), _table(rows),
                     RenderConfig(), "cpu")


@pytest.mark.parametrize("rows", [40, 300])
def test_shade_hits_wide_table_matches_jax(rows):
    """A table past the parameter block's 32 rows shades as the JAX
    package's does; ids clip to the table at both ends."""
    res, o, d, eye = shade_batch(seed=rows)
    rng = np.random.default_rng(rows + 1)
    res["material"] = rng.integers(-3, rows + 3, len(o)).astype(np.int32)
    mats = _table(rows)
    jmat = JaxMaterialTable(*(jnp.asarray(c.numpy()) for c in
                              (mats.ambient, mats.diffuse, mats.specular, mats.shininess)))
    jrig = _jax_rig()
    ref = jax_shade_hits(JaxMarchResult(**{k: jnp.asarray(v) for k, v in res.items()}),
                         o, d, jnp.asarray(eye), jrig, jmat, JaxRenderConfig(sky=SKY))
    got = shade_hits(MarchResult(**{k: torch.from_numpy(v) for k, v in res.items()}),
                     torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(eye),
                     LightRig.from_numpy(jrig), mats, RenderConfig(sky=SKY))
    for k in ("rgb", "depth", "point", "normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    t = shade_tables(eye, LightRig.default(), mats, RenderConfig(), "cpu")
    assert t.num_materials == rows and t.block.shape == (BLOCK_ROWS,)
    for got_c, want in zip(t.columns, (mats.diffuse, mats.specular, mats.shininess)):
        assert torch.equal(got_c, want)


def test_shade_tables_hold_a_full_table():
    """A table of exactly the block's rows goes in whole."""
    mats = _table(SHADE_MAX_MATERIALS)
    t = shade_tables(np.zeros(3, np.float32), LightRig.default(), mats, RenderConfig(), "cpu")
    assert t.num_materials == SHADE_MAX_MATERIALS
    np.testing.assert_array_equal(t.block[BLOCK_ROWS:].reshape(-1, MATERIAL_ROW),
                                  mats.to_matrix().numpy())
