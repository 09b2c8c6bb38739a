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
part of the kernels' launch that runs in Python.  So is what K6's cut at a
tile's last valid column rests on: the plain versions on rows cut there
give the same numbers, bit for bit, as on the whole rows.
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
from octree_raymarcher_tpu_torch.diff.composite import (
    SMEM_DEFAULT,
    WARP_RAYS,
    _smem_bytes,
    composite_backward_plain,
    composite_plain,
    composite_plan,
)

from test_torch_cuda import COMPOSITE_CASES, K6_CASES, composite_case

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
        threads = plan.rays * plan.lanes
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert 1 <= plan.chunk <= K
        assert plan.smem == _smem_bytes(plan.chunk, K, arrays, backward, plan.prefix_on_chip)
        assert plan.smem <= SMEM_DEFAULT <= SMEM_BLOCK
        assert plan.prefix_on_chip or (backward and K > 100)
    assert composite_plan(32, backward, g_weights).prefix_on_chip
    assert composite_plan(512, backward, g_weights).chunk < 512
    assert composite_plan(512, backward, g_weights).prefix_on_chip == (not backward)


# K6's plan: (K, g_weights) -> (chunk, bytes a block, kept values on chip).
# Whole rows up to K = 153 (126 with dL/dweights), then 16 columns at a time
# with the kept values on chip up to K = 238 (232), then global scratch.
K6_PLANS = {
    (1, False): (1, 512, True), (1, True): (1, 640, True),
    (16, False): (16, 5504, True), (16, True): (16, 6656, True),
    (17, False): (17, 5632, True), (17, True): (17, 6784, True),
    (32, False): (32, 10624, True), (32, True): (32, 12800, True),
    (33, False): (33, 10752, True), (33, True): (33, 12928, True),
    (120, False): (120, 38784, True), (120, True): (120, 46592, True),
    (121, False): (121, 38912, True), (121, True): (121, 46720, True),
    (153, False): (153, 49152, True), (154, False): (16, 33024, True),
    (126, True): (126, 48384, True), (127, True): (16, 28992, True),
    (238, False): (16, 49152, True), (239, False): (16, 3456, False),
    (232, True): (16, 49152, True), (233, True): (16, 4608, False),
    (300, False): (16, 3456, False), (300, True): (16, 4608, False),
}


@pytest.mark.parametrize("K,g_weights", list(K6_PLANS), ids=[f"K{k}_{'dw' if w else 'rgb'}"
                                                             for k, w in K6_PLANS])
def test_k6_plan_bytes(K, g_weights):
    """K6's launch plan in bytes: a tile of WARP_RAYS rays on one warp
    (two lanes a ray); rows of ``arrays`` staged words at a stride of 2 x an
    odd count; with whole rows tau and d sigma/dx in t0's and t1's places
    and dl and C_k kept (K x 16 words each), with chunked rows tau, d
    sigma/dx and C_k kept; each within the default 48 KB, and the handover
    from whole rows to chunks and from chunks on chip to global scratch
    where the bytes pass 48 KB."""
    chunk, smem, on_chip = K6_PLANS[(K, g_weights)]
    plan = composite_plan(K, True, g_weights)
    assert (plan.rays, plan.lanes) == (WARP_RAYS, 2) and plan.rays * plan.lanes == 32
    assert (plan.chunk, plan.smem, plan.prefix_on_chip) == (chunk, smem, on_chip)
    arrays = 4 if g_weights else 3
    stride = 2 * ((-(-chunk // 2)) | 1)
    kept = (2 if chunk >= K else 3) * K * WARP_RAYS if on_chip else 0
    assert smem == 4 * (arrays * WARP_RAYS * stride + kept) <= SMEM_DEFAULT
    # a depth gradient keeps each segment's midpoint too, with whole rows
    if chunk >= K:
        depth = composite_plan(K, True, g_weights, g_depth=True)
        assert depth.smem == smem + 4 * K * WARP_RAYS or depth.chunk < K


def _padded_case(name, pad=5):
    """A case of tests/test_torch_cuda.py as torch tensors, its row count
    rounded up to a multiple of GROUP, each row padded with ``pad``
    trailing invalid columns."""
    args = COMPOSITE_CASES[name] if name in COMPOSITE_CASES else K6_CASES[name]
    n = -(-args[0] // GROUP) * GROUP
    slot, t0, t1, dr, ar, bg, g = composite_case(n, *args[1:4],
                                                 rows=args[4] if len(args) > 4 else "random")
    rng = np.random.default_rng(3)
    slot = np.concatenate([slot, np.full((n, pad), -1, np.int32)], axis=1)
    t0 = np.concatenate([t0, t0[:, -1:] + rng.uniform(0.0, 0.3, (n, pad)).astype(np.float32)],
                        axis=1)
    t1 = np.concatenate([t1, t0[:, -pad:] + 0.1], axis=1)
    g[3] = np.concatenate([g[3], rng.normal(size=(n, pad)).astype(np.float32)], axis=1)
    g[1] = g[1] * np.float32(DEPTH_GRAD)
    to = [torch.from_numpy(np.ascontiguousarray(x)) for x in (slot, t0, t1, dr, ar, bg)]
    return (*to, [torch.from_numpy(np.ascontiguousarray(x)) for x in g])


def _last_valid(slot):
    """1 + the last column in which any of the rows has a valid slot."""
    cols = torch.nonzero((slot >= 0).any(dim=0))
    return int(cols.max()) + 1 if cols.numel() else 0


# Rows a group of the cut check takes.  Every [rows, columns] array is then a
# multiple of 64 elements, so that PyTorch's vectorised exp and log take
# each element through the same code whatever the row length: the scalar
# tail of a vectorised loop may round an element an ulp apart.  For the same
# reason the check runs on one thread (no chunk boundaries).
GROUP = 64


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", [*COMPOSITE_CASES, *K6_CASES])
def test_cut_at_last_valid_column_is_exact(name, one_thread):
    """What K6's cut rests on: with trailing all-invalid columns, the plain
    forward and backward on the rows cut at the last valid column equal the
    uncut results bit for bit (torch.equal), the cut-off weights are exactly
    0, and so for each group of GROUP rows cut at its own last valid column
    (per-ray outputs)."""
    slot, t0, t1, dr, ar, bg, g = _padded_case(name)
    n, K = slot.shape
    cut = _last_valid(slot)
    assert cut < K
    full = composite_plain(slot, t0, t1, dr, ar, bg)
    part = composite_plain(slot[:, :cut], t0[:, :cut], t1[:, :cut], dr, ar, bg)
    for a, b in zip(full[:3], part[:3]):
        assert torch.equal(a, b)
    assert torch.equal(full[3][:, :cut], part[3])
    assert torch.equal(full[3][:, cut:], torch.zeros((n, K - cut)))
    gfull = composite_backward_plain(slot, t0, t1, dr, ar, bg, 8192.0, *g)
    gpart = composite_backward_plain(slot[:, :cut], t0[:, :cut], t1[:, :cut], dr, ar, bg,
                                     8192.0, *g[:3], g[3][:, :cut])
    for a, b in zip(gfull, gpart):
        assert torch.equal(a, b)
    assert np.abs(gfull[0].numpy()).max() > 0
    for r0 in range(0, n, GROUP):                    # each group at its own cut
        rows = slice(r0, r0 + GROUP)
        c = _last_valid(slot[rows])
        group = composite_plain(slot[rows, :c], t0[rows, :c], t1[rows, :c], dr, ar, bg[rows])
        for a, b in zip(full[:3], group[:3]):
            assert torch.equal(a[rows], b)
        d_bg = composite_backward_plain(slot[rows, :c], t0[rows, :c], t1[rows, :c], dr, ar,
                                        bg[rows], 8192.0, *(x[rows] for x in g[:3]),
                                        g[3][rows, :c])[2]
        assert torch.equal(gfull[2][rows], d_bg)
