"""Runtime NaN/OOB guards for the march and composite (debug mode).

PyTorch counterpart of octree_raymarcher_tpu/ops/guards.py.  The reference
wraps its programs in ``checkify``; here each check is a reduction on the
tensors, read back to the host, that raises :class:`GuardError` with the
reference's message.  The checks run in the reference's order: the input
checks before any kernel launch, the output checks after it, and the first
one violated raises.  Each check synchronises with the device, which is why
these entry points stay off the hot path.
"""

from __future__ import annotations

import torch

from ..world.device import resolve_device, to_device
from .march import march_tiled


class GuardError(RuntimeError):
    """A guard of :func:`march_checked` or :func:`composite_checked` failed."""


def _check(ok: torch.Tensor, msg: str) -> None:
    if not bool(ok):
        raise GuardError(msg)


def _ray_checks(o: torch.Tensor, d: torch.Tensor) -> None:
    _check(torch.isfinite(o).all(), "march: non-finite ray origin")
    _check(torch.isfinite(d).all(), "march: non-finite ray direction")
    _check((torch.linalg.vector_norm(d, dim=-1) > 1e-12).all(),
           "march: zero-length ray direction")


def march_checked(world, origins, dirs, device="cuda", **kwargs):
    """:func:`march_tiled` with input/output validation; raises
    :class:`GuardError` on the first violated check.

    Checks: finite origins/dirs, non-degenerate directions, hit t finite and
    non-negative, hit materials non-zero, texel indices within the twig
    pool."""
    dev = resolve_device(device)
    o = to_device(origins, dev)
    d = to_device(dirs, dev)
    twig_cap = int(world.twig.shape[0])
    _ray_checks(o, d)
    r = march_tiled(world, o, d, device=dev, **kwargs)
    t_hit = torch.where(r.hit, r.t, 0.0)
    _check((torch.isfinite(t_hit) & (t_hit >= 0)).all(),
           "march: non-finite or negative hit distance")
    _check((torch.where(r.hit, r.material, 1) != 0).all(),
           "march: hit reported material 0 (void)")
    _check(((r.texel >= -1) & (r.texel < twig_cap)).all(),
           "march: texel index outside the twig pool")
    return r


def composite_checked(segments, params, **kwargs):
    """:func:`~octree_raymarcher_tpu_torch.diff.composite.composite` with
    validation: segment slots within the parameter table, ordered
    non-negative extents, finite outputs."""
    from ..diff.composite import composite

    P = params.num_slots
    _check((segments.slot < P).all(), "composite: segment slot out of range")
    valid = segments.slot >= 0
    _check((torch.where(valid, segments.t1 - segments.t0, 0.0) >= 0).all(),
           "composite: segment with t1 < t0")
    _check((torch.where(valid, segments.t0, 0.0) >= 0).all(),
           "composite: negative segment start")
    out = composite(segments, params, **kwargs)
    _check(torch.isfinite(out["rgb"]).all(), "composite: non-finite rgb")
    _check(torch.isfinite(out["depth"]).all(), "composite: non-finite depth")
    return out


__all__ = ["GuardError", "march_checked", "composite_checked"]
