"""VoxelScene — the flagship model: a differentiable voxel world.

PyTorch counterpart of octree_raymarcher_tpu/models/scene.py.  Bundles the
device world (octree geometry), per-voxel appearance parameters, lights and
materials, and exposes the three entry points the framework is measured on:

  * ``forward_hard``  — the production render pass (K1 march + K2 shade),
  * ``forward_soft``  — the differentiable render (K4 segments + K5
    compositing),
  * ``make_train_step`` — one Adam step of the voxel parameters (K4, K5,
    K6), with ``torch.optim.Adam`` in place of ``optax.adam`` (the same
    defaults).

Every entry point runs where the scene's world lives (``demo`` and
``from_numpy`` put it on ``cuda`` unless asked for the CPU).
"""

from __future__ import annotations

import dataclasses

import torch

from ..diff.composite import VoxelParams, composite, init_params_from_world, render_soft
from ..diff.optim import optimizer_step
from ..diff.segments import sample_segments
from ..shade.lights import LightRig
from ..shade.materials import MaterialTable
from ..shade.render import RenderConfig, render
from ..world.device import TorchWorld, single_chunk_world
from ..worldgen import BoundsPyramid, grow


@dataclasses.dataclass
class VoxelScene:
    world: TorchWorld
    params: VoxelParams
    lights: LightRig
    materials: MaterialTable
    cfg: RenderConfig = RenderConfig()

    @staticmethod
    def demo(chunk_size: float = 32.0, depth: int = 5, seed: int = 11,
             device="cuda") -> "VoxelScene":
        """Small noise-terrain scene (the graft entry's)."""
        pyr = BoundsPyramid.generate(
            size=int(chunk_size), amplitude=chunk_size / 4, period=1.0 / chunk_size,
            xshift=0.0, yshift=chunk_size * 0.4, zshift=0.0, seed=seed,
        )
        chunk = grow([0.0, 0.0, 0.0], chunk_size, depth=depth, pyr=pyr)
        world = TorchWorld.from_numpy(single_chunk_world(chunk), device=device)
        return VoxelScene(world=world, params=init_params_from_world(world),
                          lights=LightRig.default(), materials=MaterialTable.default(device))

    @staticmethod
    def from_numpy(world, params, lights, materials, device="cuda") -> "VoxelScene":
        """Carry a scene across from objects with the JAX package's fields as
        arrays (for example the JAX package's VoxelScene's): ``world`` with
        the DeviceWorld pools and chunk table, ``params`` with
        ``density_raw``/``albedo_raw``, ``lights`` a rig and ``materials`` a
        table with the same fields."""
        return VoxelScene(
            world=TorchWorld.from_numpy(world, device=device),
            params=VoxelParams.from_numpy(params.density_raw, params.albedo_raw,
                                          device=device),
            lights=LightRig.from_numpy(lights),
            materials=MaterialTable.from_numpy(materials, device=device),
        )

    def forward_hard(self, origins, dirs, eye):
        out = render(self.world, origins, dirs, eye, self.lights, self.materials, self.cfg,
                     device=self.world.device)
        return out["rgb"]

    def forward_soft(self, params: VoxelParams, origins, dirs):
        return render_soft(self.world, params, origins, dirs, device=self.world.device)["rgb"]

    def loss(self, params: VoxelParams, origins, dirs, target):
        rgb = self.forward_soft(params, origins, dirs)
        return torch.mean((rgb - torch.as_tensor(target, device=rgb.device)) ** 2)

    def make_train_step(self, lr: float = 0.05):
        """Returns (train_step, opt_state).  ``train_step(world, params,
        opt_state, origins, dirs, target) -> (params, opt_state, loss)``
        samples segments (no grad), composites, takes the mean squared rgb
        error and steps Adam.  ``opt_state`` is a ``torch.optim.Adam`` over
        its own copy of the params; the step updates it in place and returns
        new param tensors, leaving the params passed in unchanged."""
        def make_opt(values):
            return torch.optim.Adam(values, lr=lr)

        def train_step(world, params: VoxelParams, opt_state, origins, dirs, target):
            segs = sample_segments(world, origins, dirs, device=world.device)
            leaves = [params.density_raw.detach().requires_grad_(True),
                      params.albedo_raw.detach().requires_grad_(True)]
            out = composite(segs, VoxelParams(*leaves))
            tgt = torch.as_tensor(target, dtype=torch.float32, device=world.device)
            loss = torch.mean((out["rgb"] - tgt) ** 2)
            grads = torch.autograd.grad(loss, leaves)
            new, opt_state = optimizer_step(make_opt, opt_state, leaves, grads)
            return (VoxelParams(*(p.detach().clone() for p in new)), opt_state,
                    loss.detach())

        state = make_opt([self.params.density_raw.detach().clone(),
                          self.params.albedo_raw.detach().clone()])
        return train_step, state


__all__ = ["VoxelScene"]
