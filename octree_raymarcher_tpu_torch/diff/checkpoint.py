"""Checkpoint / resume for the inverse-rendering loop.

PyTorch counterpart of octree_raymarcher_tpu/diff/checkpoint.py: the step,
the voxel parameters and the optimiser state round-trip through one npz.
Each saved tree is a :class:`VoxelParams`, a ``torch.optim.Optimizer``
(its ``state_dict``), a tensor or a nested dict/list of them; tensors are
stored as arrays and the structure as JSON, and loading checks that the
templates have the saved structure.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .composite import VoxelParams


def _flatten(obj, arrays: dict, prefix: str):
    """JSON-able structure of ``obj`` with every tensor or array moved into
    ``arrays``; dict keys keep their type (optimiser state uses int keys)."""
    if isinstance(obj, torch.Tensor):
        key = f"{prefix}_{len(arrays)}"
        arrays[key] = obj.detach().cpu().numpy()
        return {"tensor": key}
    if isinstance(obj, np.ndarray):
        key = f"{prefix}_{len(arrays)}"
        arrays[key] = obj
        return {"array": key}
    if isinstance(obj, dict):
        return {"dict": [[_flatten(k, arrays, prefix), _flatten(v, arrays, prefix)]
                         for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"tuple" if isinstance(obj, tuple) else "list":
                [_flatten(v, arrays, prefix) for v in obj]}
    return {"value": obj}


def _restore(spec, z, device):
    (kind, val), = spec.items()
    if kind == "tensor":
        return torch.from_numpy(np.array(z[val])).to(device)
    if kind == "array":
        return np.array(z[val])
    if kind == "dict":
        return {_restore(k, z, device): _restore(v, z, device) for k, v in val}
    if kind in ("list", "tuple"):
        items = [_restore(v, z, device) for v in val]
        return tuple(items) if kind == "tuple" else items
    return val


def _kind(tree) -> str:
    if isinstance(tree, VoxelParams):
        return "params"
    if isinstance(tree, torch.optim.Optimizer):
        return "optimizer"
    return "tree"


def save_state(path: str, step: int, *trees) -> None:
    """Serialize (step, *trees) to an npz."""
    arrays: dict = {}
    specs = []
    for i, tree in enumerate(trees):
        kind = _kind(tree)
        if kind == "params":
            body = {"density_raw": tree.density_raw, "albedo_raw": tree.albedo_raw}
        elif kind == "optimizer":
            body = tree.state_dict()
        else:
            body = tree
        specs.append({"kind": kind, "spec": _flatten(body, arrays, f"t{i}")})
    arrays["step"] = np.int64(step)
    arrays["specs"] = np.frombuffer(json.dumps(specs).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, *templates):
    """Restore (step, *trees).  ``templates`` give the structures: a
    VoxelParams (its device is used), an Optimizer (its state is loaded in
    place and it is returned), or any tree (tensors go to the CPU).
    Raises on a structure mismatch."""
    z = np.load(path, allow_pickle=False)
    specs = json.loads(bytes(z["specs"]).decode())
    if len(specs) != len(templates):
        raise ValueError(f"checkpoint has {len(specs)} trees, caller expects {len(templates)}")
    out = []
    for tmpl, saved in zip(templates, specs):
        kind = _kind(tmpl)
        if kind != saved["kind"]:
            raise ValueError(f"checkpoint tree is a {saved['kind']}, template a {kind}")
        if kind == "params":
            body = _restore(saved["spec"], z, tmpl.density_raw.device)
            if body["density_raw"].shape != tmpl.density_raw.shape:
                raise ValueError("checkpoint params have another number of slots")
            out.append(VoxelParams(**body))
        elif kind == "optimizer":
            tmpl.load_state_dict(_restore(saved["spec"], z, "cpu"))
            out.append(tmpl)
        else:
            out.append(_restore(saved["spec"], z, "cpu"))
    return (int(z["step"]), *out)


__all__ = ["save_state", "load_state"]
