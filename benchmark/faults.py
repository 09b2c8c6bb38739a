"""Faults planted under the timed path, for the checks that the comparison
fails them (``benchmark.control`` on the card, ``tests/`` on the CPU).

Each fault patches the port in this process only:

* ``stale``: the step returns its state unchanged (a viewer frame returns
  the first frame it ever rendered; a fit step leaves the parameters as they
  were);
* ``half``: half of the batch is left out (a frame renders the first half
  of its rays and leaves the rest black misses; a fit step's loss is the
  mean over the first half of each view's rays);
* ``altered``: an answer is altered where it is produced (one pixel of each
  frame brightened by 0.25; each step's loss scaled by 1.01);
* ``frozen`` (fit only): one leaf's state returned unchanged (each step puts
  the density back as it was before Adam's update; the albedo moves).
"""

from __future__ import annotations

import contextlib

FAULTS = {"viewer": ("stale", "half", "altered"),
          "fit": ("stale", "half", "altered", "frozen")}


@contextlib.contextmanager
def planted(loop: str, fault: str):
    """Patch the port with ``fault`` for the ``loop`` ("viewer" or "fit")
    while the block runs."""
    if fault not in FAULTS[loop]:
        raise ValueError(f"unknown fault {fault!r} of the {loop} loop; one of {FAULTS[loop]}")
    patches = _viewer(fault) if loop == "viewer" else _fit(fault)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)


def _viewer(fault: str) -> list:
    import torch

    from octree_raymarcher_tpu_torch import shade

    real = shade.render_frame
    first = {}

    def frame(world, origins, dirs, *args, **kwargs):
        if fault == "stale":
            if "out" not in first:
                first["out"] = real(world, origins, dirs, *args, **kwargs)
            return first["out"]
        if fault == "half":
            h = origins.shape[0] // 2
            out = real(world, origins[:h].contiguous(), dirs[:h].contiguous(), *args, **kwargs)
            full = {}
            for k, v in out.items():
                if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == h:
                    pad = torch.zeros((origins.shape[0] - h,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device=v.device)
                    v = torch.cat([v, pad])
                full[k] = v
            return full
        out = real(world, origins, dirs, *args, **kwargs)
        out["rgb"][0] += 0.25
        return out

    return [(shade, "render_frame", frame)]


def _fit(fault: str) -> list:
    import torch

    from octree_raymarcher_tpu_torch.diff import optim
    from octree_raymarcher_tpu_torch.diff.segments import SegmentBatch

    if fault == "stale":
        def step(self, closure=None):
            return None
        return [(torch.optim.Adam, "step", step)]
    if fault == "frozen":
        real_step = torch.optim.Adam.step

        def step(self, closure=None):
            density = self.param_groups[0]["params"][0]
            kept = density.detach().clone()
            out = real_step(self, closure)
            with torch.no_grad():
                density.copy_(kept)
            return out
        return [(torch.optim.Adam, "step", step)]
    real = optim.photometric_loss
    if fault == "half":
        def loss(params, cached):
            halves = []
            for segs, target in cached:
                h = target.shape[0] // 2
                halves.append((SegmentBatch(segs.slot[:h], segs.t0[:h], segs.t1[:h],
                                            segs.count[:h]), target[:h]))
            return real(params, halves)
    else:
        def loss(params, cached):
            return real(params, cached) * 1.01
    return [(optim, "photometric_loss", loss)]
