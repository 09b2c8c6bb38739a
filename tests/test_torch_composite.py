"""The port's compositor (what K5 and K6 compute; on the CPU their plain
versions) against the JAX package's ``composite`` and ``jax.grad``, on the
synthetic segment batches of tests/test_torch_cuda.py: K of 1, 7 and 33, N
not a multiple of 32, invalid slots in the middle of rows, runs of one slot
within a ray, every valid segment on the 8 hot slots, and P < 8.  One JAX
compile per batch: its outputs and gradients come from one jitted function.

Tolerances, as in tests/test_torch_diff.py: the forward at rtol 1e-5 / atol
1e-6 (sums over K in another order, exp and log1p from another libm), the
gradients at rtol 1e-4 / atol 1e-6.

The launch plan of K5/K6 (``composite_plan``) is checked here too: it is the
part of the kernels' launch that runs in Python.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_raymarcher_tpu.diff import VoxelParams as JaxVoxelParams
from octree_raymarcher_tpu.diff import composite as jax_composite
from octree_raymarcher_tpu.diff.segments import SegmentBatch as JaxSegmentBatch
from octree_raymarcher_tpu_torch.diff import SegmentBatch, VoxelParams, composite
from octree_raymarcher_tpu_torch.diff.composite import SMEM_DEFAULT, _smem_bytes, composite_plan

from test_torch_cuda import COMPOSITE_CASES, composite_case

OUTPUTS = ("rgb", "depth", "opacity", "weights")
DEPTH_GRAD = 1e-3     # depth carries T_end * far (8192): keep its cotangent small
SMEM_BLOCK = 232_448  # bytes of shared memory one block may use on an H100


@pytest.fixture(scope="module", params=list(COMPOSITE_CASES))
def case(request):
    """(numpy inputs, JAX outputs, JAX gradients) of one batch."""
    slot, t0, t1, dr, ar, bg, g = composite_case(*COMPOSITE_CASES[request.param])
    g[1] = g[1] * np.float32(DEPTH_GRAD)
    segs = JaxSegmentBatch(slot=jnp.asarray(slot), t0=jnp.asarray(t0), t1=jnp.asarray(t1),
                           count=jnp.asarray((slot >= 0).sum(axis=1, dtype=np.int32)))

    def loss(params, sky):
        out = jax_composite(segs, params, sky_rgb=sky)
        return sum((out[k] * gk).sum() for k, gk in zip(OUTPUTS, g)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        JaxVoxelParams(density_raw=jnp.asarray(dr), albedo_raw=jnp.asarray(ar)),
        jnp.asarray(bg))
    return (slot, t0, t1, dr, ar, bg, g), out, grads


def _port(inputs):
    """The port's composite on the CPU with leaf params and sky; returns
    (outputs, params, sky)."""
    slot, t0, t1, dr, ar, bg, _ = inputs
    segs = SegmentBatch(*(torch.from_numpy(x) for x in (slot, t0, t1)),
                        count=torch.from_numpy((slot >= 0).sum(axis=1, dtype=np.int32)))
    params = VoxelParams(torch.from_numpy(dr).requires_grad_(True),
                         torch.from_numpy(ar).requires_grad_(True))
    sky = torch.from_numpy(bg).requires_grad_(True)
    return composite(segs, params, sky_rgb=sky), params, sky


def test_composite_forward_matches_jax(case):
    inputs, ref, _ = case
    out, _, _ = _port(inputs)
    for k in OUTPUTS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    weights = out["weights"].detach().numpy()
    assert (weights[inputs[0] < 0] == 0).all()


def test_composite_gradients_match_jax(case):
    inputs, _, (gp, gs) = case
    out, params, sky = _port(inputs)
    g = [torch.from_numpy(x) for x in inputs[6]]
    torch.autograd.backward([out[k] for k in OUTPUTS], g)
    for got, ref in ((params.density_raw.grad, gp.density_raw),
                     (params.albedo_raw.grad, gp.albedo_raw), (sky.grad, gs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    assert np.abs(np.asarray(gp.density_raw)).max() > 1e-3


@pytest.mark.parametrize("backward,g_weights", [(False, False), (True, False), (True, True)],
                         ids=["K5", "K6", "K6_with_dweights"])
def test_composite_plan(backward, g_weights):
    """Every K from 1 to 512 (and far beyond) has a plan: whole warps per
    tile, its shared memory within a block's 232,448 bytes (and the default
    48 KB), rows longer than a chunk streamed in chunks, and K6's prefix
    sums on chip at the training path's K = 32, in global scratch only for
    long rows."""
    arrays = 4 if g_weights else 3
    for K in [*range(1, 513), 5000, 100_000]:
        plan = composite_plan(K, backward, g_weights)
        assert plan.rays % 32 == 0 and 32 <= plan.rays <= 256
        assert 1 <= plan.chunk <= K
        assert plan.smem == _smem_bytes(plan.chunk, K, arrays, backward, plan.prefix_on_chip)
        assert plan.smem <= SMEM_DEFAULT <= SMEM_BLOCK
        assert plan.prefix_on_chip or (backward and K > 100)
    assert composite_plan(32, backward, g_weights).prefix_on_chip
    assert composite_plan(512, backward, g_weights).chunk < 512
    assert composite_plan(512, backward, g_weights).prefix_on_chip == (not backward)
