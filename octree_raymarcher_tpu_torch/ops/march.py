"""The octree march: CUDA kernel K1 (csrc/march.cu) and its plain version.

PyTorch counterpart of octree_raymarcher_tpu/ops/march_jnp.py.  For each ray:
a world-box slab entry test (or a resume at ``t_start``), then up to
``max_steps`` steps, each of which locates the ray point's chunk (toroidal
lookup), descends the chunk's octree to the cell at the point, stops on a
solid LEAF cell or twig texel, and otherwise escapes the cell (or texel) box
by its slab distance with the EPS/BIGEPS clamp.  The hit record (material,
cell, flat texel) is taken at the frozen t.

On a CUDA tensor :func:`march` launches the kernel, one thread per ray; on a
CPU tensor it runs :func:`march_plain`, which repeats the kernel's arithmetic
op for op on the rays still live.  Semantics kept from the reference:

* the loop bound is ``unroll * ceil(max_steps / unroll)`` (the reference's
  while loop runs in unrolls of ``unroll``, 4 by default); a ray still live
  at the bound is a miss, or, with ``_expose_live_t``, reports its current t
  (the resume support of march_jnp.py:642-652);
* ``step_budget`` (march_jnp.py:596-616): iterations fall into stages of
  ``stride = max(unroll, (steps_stride // unroll) * unroll)``, at most
  ``ceil(max_steps / stride)`` of them; a ray enters a stage only while its
  charge is below its budget, each stage entered charges a full stride, a
  ray whose budget runs out is a miss, and ``.steps`` returns the charge;
* a step counts while the ray is live and resident (the exact ``steps``
  AOV of ``march(steps_aov=True)``); ``steps_aov=False`` returns zeros;
* t is clamped to T_CLAMP before each step's geometry, and the entry t to
  T_CLAMP with its sign cleared;
* dead or never-entered rays report t=inf, material 0, cell 0, texel -1.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import BIGEPS, EPS, FAR, MAX_STEPS, TWIG_SIZE, TWIG_WORDS
from ..core.geometry import const, inv_dir, vp_row
from ..kernels import Kernel, c_floats, ptr
from ..world.device import TorchWorld, resolve_device, to_device

T_CLAMP = 1e8      # |t| clamp before cell math (march_jnp._T_CLAMP)
_U30 = (1 << 30) - 1
_BRANCH, _LEAF, _TWIG = 2, 1, 3

MARCH_KERNEL = Kernel("ort_march")
MARCH_DEPTH_KERNEL = Kernel("ort_march_depth")


@dataclasses.dataclass
class MarchResult:
    hit: torch.Tensor        # bool[N]
    t: torch.Tensor          # float32[N] distance to hit (inf when miss)
    material: torch.Tensor   # int32[N] material id (0 when miss)
    cell_bmin: torch.Tensor  # float32[N,3] hit cell min corner
    cell_size: torch.Tensor  # float32[N] hit cell edge
    steps: torch.Tensor      # int32[N] traversal steps (zeros unless steps_aov)
    texel: torch.Tensor      # int32[N] flat twig-texel index, -1 for LEAF hits/misses


def loop_bound(max_steps: int, unroll: int = 4) -> int:
    """Iterations the reference runs at most: max_steps rounded up to a
    multiple of the loop's unroll."""
    u = int(unroll)
    return u * ((int(max_steps) + u - 1) // u)


def budget_stride(steps_stride: int, unroll: int = 4) -> int:
    """The budget's stage length: steps_stride rounded down to the loop's
    unroll, at least one unroll."""
    u = int(unroll)
    return max(u, (int(steps_stride) // u) * u)


def budget_cap(max_steps: int, stride: int) -> int:
    """Iterations a budgeted march runs at most: whole stages covering
    max_steps."""
    return ((int(max_steps) + stride - 1) // stride) * stride


def _world_box(world: TorchWorld, like):
    cs = world.chunksize
    w, h, d = world.dims
    lo = world.chunkcoordmin.to(like.device) * cs            # f32[3]
    hi = lo + torch.tensor([float(w), float(h), float(d)], device=like.device) * cs
    return lo, hi


def _entry(world, o, d, g, t_start, live_start):
    """(t0, live0) at the world entry, or at the resume parameter."""
    n = o.shape[0]
    if t_start is None:
        lo, hi = _world_box(world, o)
        ta = (lo - o) * g
        tb = (hi - o) * g
        t1 = torch.minimum(ta, tb)
        t2 = torch.maximum(ta, tb)
        tnear = torch.maximum(t1[:, 0], torch.maximum(t1[:, 1], t1[:, 2]))
        tfar = torch.minimum(t2[:, 0], torch.minimum(t2[:, 1], t2[:, 2]))
        inside0 = ((o >= lo) & (o <= hi)).all(dim=1)
        enter_ok = (tfar > tnear) & (tnear > 0)
        t0 = (1.0 - inside0.to(torch.float32)) * (tnear + EPS)
        live0 = inside0 | enter_ok
    else:
        t0 = torch.clamp_min(t_start.to(torch.float32), 0.0)
        live0 = torch.ones(n, dtype=torch.bool, device=o.device)
    if live_start is not None:
        live0 = live0 & (live_start != 0)
    return torch.clamp_max(t0, T_CLAMP).abs(), live0


def _locate(world, p, assume_resident):
    """Chunk lookup + descent for points p f32[m,3] -> (in_chunk, word,
    bm f32[m,3], size f32[m], twig_off i32[m])."""
    w, h, d = world.dims
    q = torch.floor(p / const(p, world.chunksize))
    qi = q.to(torch.int32)
    ci = (torch.remainder(qi[:, 0], w) + torch.remainder(qi[:, 2], d) * w
          + torch.remainder(qi[:, 1], h) * (w * d))
    ci = ci.clamp(0, world.num_chunks - 1).long()
    bm = q * world.chunksize
    if assume_resident:
        in_chunk = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    else:
        in_chunk = (world.chunk_bmin[ci] == bm).all(dim=1)
    tree_off = world.chunk_tree[ci].long()
    twig_off = world.chunk_twig[ci]
    size = torch.full((p.shape[0],), world.chunksize, dtype=torch.float32, device=p.device)
    tree_len = world.tree.shape[0]
    word = world.tree[tree_off]
    for _ in range(world.depth):
        mb = ((word >> 30) & 3) == _BRANCH
        payload = word & _U30
        half = size * 0.5
        ge = p >= bm + half[:, None]
        bm = torch.where(mb[:, None], bm + torch.where(ge, half[:, None], 0.0), bm)
        size = torch.where(mb, size - half, size)
        child = payload + ge[:, 0].int() + 2 * ge[:, 1].int() + 4 * ge[:, 2].int()
        nxt = world.tree[(tree_off + child.long()).clamp(0, tree_len - 1)]
        word = torch.where(mb, nxt, word)
    return in_chunk, word, bm, size, twig_off


def march_plain(
    world: TorchWorld,
    o: torch.Tensor,
    d: torch.Tensor,
    max_steps: int = MAX_STEPS,
    steps_aov: bool = False,
    t_start=None,
    live_start=None,
    assume_resident: bool = False,
    step_budget=None,
    steps_stride: int = 16,
    expose_live_t: bool = False,
    unroll: int = 4,
    iter_caps=None,
) -> MarchResult:
    """The march in plain PyTorch ops: K1's arithmetic, step by step, over
    the rays still live (rays are independent, so compacting them changes
    no result).  ``iter_caps`` (int32[N], no budget) gives each ray its own
    iteration cap in place of ``max_steps``: a ray stops, live, after that
    many iterations."""
    n = o.shape[0]
    dev = o.device
    g = inv_dir(d)
    lo, hi = _world_box(world, o)
    t, live0 = _entry(world, o, d, g, t_start, live_start)

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t_out = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    material = torch.zeros(n, dtype=torch.int32, device=dev)
    cell_bmin = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    cell_size = torch.zeros(n, dtype=torch.float32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    texel = torch.full((n,), -1, dtype=torch.int32, device=dev)

    act = torch.nonzero(live0).flatten()
    ta = t[act]
    occ_len = world.twig_occ.shape[0]
    twig_len = world.twig.shape[0]
    budgeted = step_budget is not None
    stride = budget_stride(steps_stride, unroll)
    cap = budget_cap(max_steps, stride) if budgeted else loop_bound(max_steps, unroll)
    if iter_caps is not None:
        cap = int(iter_caps.max()) if n else 0
    charged = torch.zeros(n, dtype=torch.int32, device=dev)
    for it in range(cap):
        if act.numel() == 0:
            break
        if iter_caps is not None:
            stop = iter_caps[act] <= it
            if bool(stop.any()):           # live at their own cap
                if expose_live_t:
                    t_out[act[stop]] = ta[stop]
                act, ta = act[~stop], ta[~stop]
                if act.numel() == 0:
                    break
        if budgeted and it % stride == 0:
            # stage boundary: out of budget -> miss; else charge a stride
            ok = charged[act] < step_budget[act]
            act, ta = act[ok], ta[ok]
            charged[act] += stride
            if act.numel() == 0:
                break
        a, b, ga = o[act], d[act], g[act]
        tg = torch.clamp_max(ta, T_CLAMP)
        p = a + b * tg[:, None]
        in_world = ((p >= lo) & (p <= hi)).all(dim=1)
        in_chunk, word, bm, size, twig_off = _locate(world, p, assume_resident)
        resident = in_world & in_chunk
        steps[act] += resident.to(torch.int32)

        # ---- solid probe ----------------------------------------------------
        ty = (word >> 30) & 3
        payload = word & _U30
        m_leaf = ty == _LEAF
        m_twig = ty == _TWIG
        leafsize = size * (1.0 / TWIG_SIZE)
        inv_ls = 1.0 / leafsize
        to = torch.clamp((p - bm) * inv_ls[:, None], 0.0, TWIG_SIZE - 1).to(torch.int32)
        tword = to[:, 2] * (TWIG_SIZE * TWIG_SIZE) + to[:, 1] * TWIG_SIZE + to[:, 0]
        base = (twig_off + payload).long()
        oi = (base * 2 + (tword >> 5).long()).clamp(0, occ_len - 1)
        tex_solid = ((world.twig_occ[oi] >> (tword & 31)) & 1) == 1
        solid = resident & (m_leaf | (m_twig & tex_solid))
        offs = to.to(torch.float32) * leafsize[:, None]      # texel box corner

        # ---- hit record at the frozen t -------------------------------------
        if bool(solid.any()):
            hi_idx = act[solid]
            ti = (base * TWIG_WORDS + tword.long()).clamp(0, twig_len - 1)
            leaf_s = m_leaf[solid]
            hit[hi_idx] = True
            t_out[hi_idx] = ta[solid]
            material[hi_idx] = torch.where(m_leaf, payload, world.twig[ti])[solid]
            cell_bmin[hi_idx] = (bm + torch.where(m_leaf[:, None], 0.0, offs))[solid]
            cell_size[hi_idx] = torch.where(
                leaf_s, size[solid], size[solid] + (leafsize[solid] - size[solid]))
            texel[hi_idx] = torch.where(leaf_s, -1, ti[solid].to(torch.int32))

        # ---- advance: escape the (cell | texel) box --------------------------
        e = bm + torch.where(m_twig[:, None], offs, 0.0)
        esize = torch.where(m_twig, size + (leafsize - size), size)
        dd = torch.maximum((e - p) * ga, (e + esize[:, None] - p) * ga)
        esc = torch.minimum(dd[:, 0], torch.minimum(dd[:, 1], dd[:, 2]))
        esc = torch.where(esc < EPS, esc + (BIGEPS - esc), esc)
        esc = esc + EPS
        adv = resident & ~solid
        act = act[adv]
        ta = (tg + esc)[adv]

    if expose_live_t:
        t_out[act] = ta           # rays still live at the cap
    if budgeted:
        steps = charged
    elif not steps_aov:
        steps.zero_()
    return MarchResult(hit=hit, t=t_out, material=material, cell_bmin=cell_bmin,
                       cell_size=cell_size, steps=steps, texel=texel)


def _march_cuda(world, o, d, max_steps, steps_aov, t_start, live_start,
                assume_resident, step_budget=None, steps_stride=16,
                expose_live_t=False, unroll=4) -> MarchResult:
    """Launch K1 on PyTorch's current stream; outputs allocated here."""
    n = o.shape[0]
    dev = o.device
    res = MarchResult(
        hit=torch.empty(n, dtype=torch.bool, device=dev),
        t=torch.empty(n, dtype=torch.float32, device=dev),
        material=torch.empty(n, dtype=torch.int32, device=dev),
        cell_bmin=torch.empty((n, 3), dtype=torch.float32, device=dev),
        cell_size=torch.empty(n, dtype=torch.float32, device=dev),
        steps=torch.empty(n, dtype=torch.int32, device=dev),
        texel=torch.empty(n, dtype=torch.int32, device=dev),
    )
    stride = budget_stride(steps_stride, unroll)
    cap = (budget_cap(max_steps, stride) if step_budget is not None
           else loop_bound(max_steps, unroll))
    MARCH_KERNEL(
        *world_args(world), ptr(o), ptr(d), ptr(t_start), ptr(live_start),
        ptr(step_budget), n, cap, stride, int(bool(assume_resident)),
        int(bool(steps_aov)), int(bool(expose_live_t)),
        ptr(res.hit), ptr(res.t), ptr(res.material), ptr(res.cell_bmin),
        ptr(res.cell_size), ptr(res.steps), ptr(res.texel),
    )
    return res


def world_args(world: TorchWorld) -> tuple:
    """The world half of a march-kernel call (csrc/march_step.cuh
    world_args): pools, chunk table, grid and pool lengths."""
    w, h, dd = world.dims
    return (ptr(world.tree), ptr(world.twig), ptr(world.twig_occ),
            ptr(world.chunk_bmin), ptr(world.chunk_tree), ptr(world.chunk_twig),
            ptr(world.chunkcoordmin), float(world.chunksize), w, h, dd, world.depth,
            world.twig.shape[0], world.twig_occ.shape[0])


def check_world(world: TorchWorld, dev: torch.device):
    if world.device.type != dev.type:
        raise ValueError(f"world lives on {world.device}, rays asked for {dev}")
    for name in ("tree", "twig", "twig_occ", "chunk_tree", "chunk_twig"):
        t = getattr(world, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"world.{name} must be a contiguous int32 tensor")
    for name in ("chunk_bmin", "chunkcoordmin"):
        t = getattr(world, name)
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"world.{name} must be a contiguous float32 tensor")
    v = world.num_chunks
    if (tuple(world.chunk_bmin.shape) != (v, 3) or world.chunk_tree.shape != (v,)
            or world.chunk_twig.shape != (v,) or world.chunkcoordmin.shape != (3,)):
        raise ValueError(f"world chunk table must describe dims {world.dims}")


def march(
    world: TorchWorld,
    origins,
    dirs,
    max_steps: int = MAX_STEPS,
    unroll: int = 4,
    steps_aov=False,
    t_start=None,
    live_start=None,
    steps_stride: int = 16,
    assume_resident: bool = False,
    step_budget=None,
    *,
    _expose_live_t: bool = False,
    device="cuda",
) -> MarchResult:
    """March N rays through ``world``; returns a :class:`MarchResult`.

    The arguments up to ``step_budget`` come in the reference's order
    (march_jnp.py:474-485); the rest are keyword-only.
    ``origins``/``dirs`` (f32[N,3], numpy or tensors) are placed on
    ``device``, where ``world`` must live.  On ``cuda`` this launches K1;
    ``device="cpu"`` runs :func:`march_plain`.  ``unroll`` sets the loop
    bound and the budget's stage length as the reference's unroll does (see
    the module docstring).  ``t_start``/``live_start`` resume a march
    mid-ray: with ``t_start`` the entry test is skipped and ray i starts at
    ``max(t_start[i], 0)``; ``live_start`` (0/1) starts rays dead at no
    cost.  ``assume_resident`` skips the per-step chunk residency test
    (valid for a static world).  ``step_budget`` (int32[N]) charges each ray
    ``stride`` iterations per stage entered (see the module docstring) and
    returns the charge in ``.steps``; it excludes ``steps_aov=True``.
    ``_expose_live_t`` makes rays still live at the cap report their current
    t instead of inf."""
    dev = resolve_device(device)
    check_world(world, dev)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"origins/dirs must be f32[N,3], got {tuple(o.shape)}, {tuple(d.shape)}")
    if int(unroll) < 1:
        raise ValueError(f"unroll must be at least 1, got {unroll}")
    if t_start is not None:
        t_start = to_device(t_start, dev)
    if live_start is not None:
        live_start = to_device(live_start, dev, torch.int32)
    if step_budget is not None:
        if steps_aov is True:
            raise ValueError("step_budget returns the charge in .steps; it excludes "
                             "steps_aov=True")
        step_budget = to_device(step_budget, dev, torch.int32)
    for name, x in (("t_start", t_start), ("live_start", live_start),
                    ("step_budget", step_budget)):
        if x is not None and x.shape != (o.shape[0],):
            raise ValueError(f"{name} must have shape ({o.shape[0]},), got {tuple(x.shape)}")
    steps_aov = bool(steps_aov)
    fn = _march_cuda if o.is_cuda else march_plain
    return fn(world, o, d, max_steps, steps_aov, t_start, live_start, assume_resident,
              step_budget, steps_stride, _expose_live_t, unroll)


def march_tiled(world, origins, dirs, max_steps: int = MAX_STEPS, tile: int = 8192,
                unroll: int = 4, steps_aov=False, live_start=None, steps_stride: int = 16,
                assume_resident: bool = False, device="cuda") -> MarchResult:
    """:func:`march` over the whole batch in one launch; ``tile`` is
    accepted for callers of the reference and ignored."""
    return march(world, origins, dirs, max_steps, unroll, steps_aov, live_start=live_start,
                 steps_stride=steps_stride, assume_resident=assume_resident, device=device)


def march_frame(world, origins, dirs, max_steps: int = MAX_STEPS, tile: int = 65536,
                assume_resident: bool = False, live_start=None,
                device="cuda") -> MarchResult:
    """:func:`march` over the whole batch in one launch; ``tile`` is
    accepted for callers of the reference and ignored."""
    return march(world, origins, dirs, max_steps, live_start=live_start,
                 assume_resident=assume_resident, device=device)


# ---- the light pass: K1 with the light-depth epilogue ---------------------------

def light_depth_plain(o, d, hit, t, depth_row):
    """The light depth of marched light rays in plain PyTorch ops: row 2 of
    the light's view-projection (``depth_row``, 4 floats) times
    [o + d*t, 1] where the ray hit, 1.0 where it missed."""
    p = o + d * torch.where(hit, t, FAR)[:, None]
    return torch.where(hit, vp_row(p, depth_row), 1.0)


def march_depth_plain(world: TorchWorld, o, d, depth_row, max_steps: int = MAX_STEPS,
                      assume_resident: bool = False) -> torch.Tensor:
    """The light-depth march in plain PyTorch ops: :func:`march_plain`, then
    :func:`light_depth_plain` of its hits."""
    res = march_plain(world, o, d, max_steps, False, None, None, assume_resident)
    return light_depth_plain(o, d, res.hit, res.t, depth_row)


def _march_depth_cuda(world, o, d, depth_row, max_steps, assume_resident):
    """Launch K1's light-depth instantiation; the output allocated here."""
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    MARCH_DEPTH_KERNEL(*world_args(world), ptr(o), ptr(d), o.shape[0], loop_bound(max_steps),
                       int(bool(assume_resident)), c_floats(depth_row), ptr(out))
    return out


def march_depth(world: TorchWorld, origins, dirs, depth_row, max_steps: int = MAX_STEPS,
                assume_resident: bool = False, device="cuda") -> torch.Tensor:
    """f32[N] light depth of rays marched from the world entry with the
    default unroll, as the reference's light pass marches: what ``march``
    then the resolve of shade/shadow.py give, in one pass.  On ``cuda`` this
    launches K1 with its light-depth epilogue (no hit record is written);
    ``device="cpu"`` runs :func:`march_depth_plain`."""
    dev = resolve_device(device)
    check_world(world, dev)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"origins/dirs must be f32[N,3], got {tuple(o.shape)}, {tuple(d.shape)}")
    if len(depth_row) != 4:
        raise ValueError("depth_row must hold the 4 floats of one view-projection row")
    fn = _march_depth_cuda if o.is_cuda else march_depth_plain
    return fn(world, o, d, depth_row, max_steps, assume_resident)


__all__ = ["MarchResult", "march", "march_plain", "march_tiled", "march_frame",
           "march_depth", "march_depth_plain", "light_depth_plain", "MARCH_DEPTH_KERNEL",
           "MARCH_KERNEL", "T_CLAMP", "loop_bound", "budget_stride", "budget_cap",
           "world_args", "check_world"]
