"""The port's atlas sheet I/O and ``depth_to_distance`` against the JAX
package's (tests/test_shade_assets.py:61-78 and core/geometry.py:98).

The sheet, the PNG bytes and the atlas read back are exact: both packages
run the same numpy code.  ``depth_to_distance`` is held at rtol 1e-6: XLA
may contract its multiply-add into one rounding where eager PyTorch rounds
twice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.core.geometry import depth_to_distance as jax_depth_to_distance
from octree_raymarcher_tpu.core.geometry import inverse_depth as jax_inverse_depth
from octree_raymarcher_tpu.shade.atlas import atlas_from_sheet as jax_atlas_from_sheet
from octree_raymarcher_tpu.shade.atlas import default_atlas as jax_default_atlas
from octree_raymarcher_tpu.shade.atlas import save_atlas_png as jax_save_atlas_png
from octree_raymarcher_tpu.shade.atlas import sheet_from_atlas as jax_sheet_from_atlas
from octree_raymarcher_tpu_torch.core.constants import FAR, NEAR
from octree_raymarcher_tpu_torch.core.geometry import depth_to_distance, inverse_depth
from octree_raymarcher_tpu_torch.shade import (
    atlas_from_sheet,
    default_atlas,
    load_atlas_png,
    save_atlas_png,
    sheet_from_atlas,
)
from octree_raymarcher_tpu_torch.utils.png import load_png


def test_atlas_sheet_leafuv_addressing(tmp_path):
    """The port's sheet uses the leafUV layout (x = m & 0xff, y = m >> 8) and
    round-trips through PNG, as tests/test_shade_assets.py:61-78 holds the
    reference's."""
    atlas = default_atlas(resolution=8, seed=2)
    sheet = sheet_from_atlas(atlas)
    assert sheet.shape == (8, 8 * 8, 3)
    for m in range(8):
        tile = sheet[:, m * 8:(m + 1) * 8].astype(np.float32) / 255.0
        np.testing.assert_allclose(tile, atlas[m], atol=1 / 255.0 + 1e-6)

    p = str(tmp_path / "atlas.png")
    save_atlas_png(p, atlas)
    back = load_atlas_png(p, 8)
    np.testing.assert_allclose(back, atlas, atol=1 / 255.0 + 1e-6)
    np.testing.assert_array_equal(back, atlas_from_sheet(load_png(p), 8))


@pytest.mark.parametrize("num", [8, 300])
def test_sheet_matches_reference(tmp_path, num):
    """Sheet, PNG bytes and the atlas read back equal the reference's, for
    one row of tiles and for more than 256 materials (a second row)."""
    rng = np.random.default_rng(num)
    atlas = rng.uniform(-0.1, 1.1, size=(num, 4, 4, 3)).astype(np.float32)
    sheet = sheet_from_atlas(atlas)
    np.testing.assert_array_equal(sheet, jax_sheet_from_atlas(atlas))
    assert sheet.shape == (((num + 255) // 256) * 4, min(num, 256) * 4, 3)

    mine, ref = tmp_path / "port.png", tmp_path / "ref.png"
    save_atlas_png(str(mine), atlas)
    jax_save_atlas_png(str(ref), atlas)
    assert mine.read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(load_atlas_png(str(mine), 4, num),
                                  jax_atlas_from_sheet(load_png(str(ref)), 4, num))


def test_default_atlas_matches_reference():
    np.testing.assert_array_equal(default_atlas(resolution=16, seed=5),
                                  jax_default_atlas(resolution=16, seed=5))


def test_atlas_from_sheet_rgba_and_too_small():
    rng = np.random.default_rng(0)
    sheet = rng.integers(0, 256, size=(4, 12, 4), dtype=np.uint8)
    np.testing.assert_array_equal(atlas_from_sheet(sheet, 4, 3),
                                  jax_atlas_from_sheet(sheet, 4, 3))
    with pytest.raises(ValueError, match="too small"):
        atlas_from_sheet(sheet, 4, 4)


def test_depth_to_distance_matches_reference():
    rng = np.random.default_rng(7)
    dist = np.concatenate([rng.uniform(NEAR, FAR, 4096),
                           np.exp(rng.uniform(np.log(NEAR), np.log(FAR), 4096)),
                           [NEAR, FAR, 1.0, 10.0]]).astype(np.float32)
    codes = np.asarray(jax_inverse_depth(jnp.asarray(dist)))
    codes = np.concatenate([codes, np.float32([0.0, 1.0, 1.5, -0.5])])
    got = depth_to_distance(torch.from_numpy(codes)).numpy()
    ref = np.asarray(jax_depth_to_distance(jnp.asarray(codes)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # the exact inverse of inverse_depth, up to float32 rounding of the code
    back = depth_to_distance(inverse_depth(torch.from_numpy(dist))).numpy()
    np.testing.assert_allclose(back, dist, rtol=2e-3)
    # the clamp of the inverse at 1/FAR: codes past the far plane decode to FAR
    assert got[-2] == np.float32(FAR) and ref[-2] == np.float32(FAR)
