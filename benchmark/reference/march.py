"""The octree march in plain PyTorch ops (frozen copy of the port's
ops/march.py march_plain and the light-depth pass)."""

from __future__ import annotations

import dataclasses

import torch

from .constants import BIGEPS, EPS, FAR, MAX_STEPS, TWIG_SIZE, TWIG_WORDS
from .geometry import const, inv_dir, vp_row
from .device import TorchWorld

T_CLAMP = 1e8      # |t| clamp before cell math (march_jnp._T_CLAMP)


_U30 = (1 << 30) - 1


_BRANCH, _LEAF, _TWIG = 2, 1, 3


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
