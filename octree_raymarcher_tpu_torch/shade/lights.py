"""Light models and Blinn-Phong shading over ray batches.

PyTorch counterpart of octree_raymarcher_tpu/shade/lights.py (reference
src/Light.{h,cpp} and shaders/World.Fragment.glsl:75-138: three Blinn-Phong
accumulators with distance attenuation and the spotlight cone falloff).
Light parameters are host (numpy float32) values; :meth:`LightRig.to_vector`
flattens a rig into the 50-float layout of the shading kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.geometry import const, dot, length, normalize


def _np(v):
    return np.asarray(v, dtype=np.float32)


def _np_norm(v):
    a = np.asarray(v, dtype=np.float64)
    return (a / max(float(np.linalg.norm(a)), 1e-12)).astype(np.float32)


@dataclasses.dataclass
class PointLight:
    position: Any
    ambient: Any
    diffuse: Any
    specular: Any
    constant: Any = 1.0
    linear: Any = 0.14
    quadratic: Any = 0.09

    @staticmethod
    def default() -> "PointLight":
        return PointLight(
            position=_np([50.0, 8.0, 65.0]),
            ambient=_np([0.1, 0.1, 0.1]),
            diffuse=_np([0.5, 0.5, 0.5]),
            specular=_np([1.0, 1.0, 1.0]),
        )


@dataclasses.dataclass
class DirectionalLight:
    position: Any    # used only by the shadow pass / depth encoding
    direction: Any
    ambient: Any
    diffuse: Any
    specular: Any

    @staticmethod
    def default() -> "DirectionalLight":
        return DirectionalLight(
            position=_np([250.0, 125.0, 250.0]),
            direction=_np_norm([1.0, -1.0, 0.0]),
            ambient=_np([0.2, 0.3, 0.4]),
            diffuse=_np([0.3, 0.3, 0.6]),
            specular=_np([0.0, 0.0, 0.0]),
        )


@dataclasses.dataclass
class Spotlight:
    position: Any
    direction: Any
    ambient: Any
    diffuse: Any
    specular: Any
    cos_phi: Any      # inner cone cosine
    cos_gamma: Any    # outer cone cosine
    constant: Any = 1.0
    linear: Any = 0.045
    quadratic: Any = 0.0075

    @staticmethod
    def default() -> "Spotlight":
        return Spotlight(
            position=_np([50.0, 20.0, 70.0]),
            direction=_np_norm([-0.1, -1.0, -0.1]),
            ambient=_np([0.2, 0.8, 0.3]),
            diffuse=_np([0.2, 0.8, 0.3]),
            specular=_np([1.0, 1.0, 1.0]),
            cos_phi=np.float32(np.cos(np.deg2rad(25.0))),
            cos_gamma=np.float32(np.cos(np.deg2rad(35.0))),
        )


# LightRig.to_vector layout: (light, field, width) in order; 50 floats.
VECTOR_LAYOUT = (
    ("point", "position", 3), ("point", "ambient", 3), ("point", "diffuse", 3),
    ("point", "specular", 3), ("point", "constant", 1), ("point", "linear", 1),
    ("point", "quadratic", 1),
    ("directional", "position", 3), ("directional", "direction", 3),
    ("directional", "ambient", 3), ("directional", "diffuse", 3),
    ("directional", "specular", 3),
    ("spot", "position", 3), ("spot", "direction", 3), ("spot", "ambient", 3),
    ("spot", "diffuse", 3), ("spot", "specular", 3), ("spot", "cos_phi", 1),
    ("spot", "cos_gamma", 1), ("spot", "constant", 1), ("spot", "linear", 1),
    ("spot", "quadratic", 1),
)


# Host leaf types, tested before torch.Tensor: isinstance against a tensor
# type goes through torch's metaclass, which costs more than the rest of a
# leaf's handling, and the rig's checks run on every shading call.
_HOST = (np.ndarray, np.generic, float, int)


def host_leaf(v) -> np.ndarray:
    """A light leaf as host float32 numpy (a tensor is detached and read
    back: one small copy for a leaf on the card)."""
    if not isinstance(v, _HOST) and isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.asarray(v, dtype=np.float32)


def _t(v, like):
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, dtype=np.float32), device=like.device)


def _scalar(v, like):
    """A scalar leaf: a host value as a Python float of its float32 value,
    a tensor as a 0-d float32 tensor on like's device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32).reshape(())
    return float(np.float32(v))


def _max(x, c: float):
    """``jnp.maximum(x, c)``: its value, and half the gradient at a tie."""
    return torch.maximum(x, const(x, c))


def _clip01(x):
    """``jnp.clip(x, 0, 1)``, a maximum then a minimum."""
    return torch.minimum(_max(x, 0.0), const(x, 1.0))


def _blinn_terms(n, l, v, shininess):
    h = normalize(l + v)
    d = _max(dot(n, l), 0.0)
    s = torch.pow(_max(dot(v, h), 1e-6), shininess)
    return d, s


def _terms(light, d, s, diffuse, specular, lit, p):
    amb = _t(light.ambient, p) * diffuse
    diff = _t(light.diffuse, p) * d[..., None] * diffuse * lit[..., None]
    spec = _t(light.specular, p) * s[..., None] * specular * lit[..., None]
    return amb, diff, spec


def _attenuation(light, dist):
    kc, kl, kq = (_scalar(x, dist) for x in (light.constant, light.linear, light.quadratic))
    return 1.0 / (kc + kl * dist + kq * dist * dist)


def shade_point_light(light: PointLight, n, p, eye, diffuse, specular, shininess, shadow):
    pos = _t(light.position, p)
    l = normalize(pos - p)
    v = normalize(eye - p)
    d, s = _blinn_terms(n, l, v, shininess)
    att = _attenuation(light, length(p - pos))
    amb, diff, spec = _terms(light, d, s, diffuse, specular, 1.0 - shadow, p)
    return (amb + diff + spec) * att[..., None]


def shade_directional_light(light: DirectionalLight, n, p, eye, diffuse, specular,
                            shininess, shadow):
    l = normalize(-_t(light.direction, p))
    v = normalize(eye - p)
    d, s = _blinn_terms(n, l, v, shininess)
    amb, diff, spec = _terms(light, d, s, diffuse, specular, 1.0 - shadow, p)
    return amb + diff + spec


def shade_spotlight(light: Spotlight, n, p, eye, diffuse, specular, shininess, shadow):
    pos = _t(light.position, p)
    l = normalize(pos - p)
    v = normalize(eye - p)
    d, s = _blinn_terms(n, l, v, shininess)
    att = _attenuation(light, length(p - pos))
    theta = dot(l, normalize(-_t(light.direction, p)))
    if isinstance(light.cos_phi, torch.Tensor) or isinstance(light.cos_gamma, torch.Tensor):
        cphi, cgam = _scalar(light.cos_phi, p), _scalar(light.cos_gamma, p)
        intensity = _clip01((theta - cgam) / _max(cphi - cgam, 1e-6))
    else:
        cphi, cgam = np.float32(light.cos_phi), np.float32(light.cos_gamma)
        cone = max(cphi - cgam, np.float32(1e-6))            # float32 on the host
        intensity = _clip01((theta - float(cgam)) / const(theta, float(cone)))
    amb, diff, spec = _terms(light, d, s, diffuse, specular, 1.0 - shadow, p)
    return (amb + (diff + spec) * intensity[..., None]) * att[..., None]


@dataclasses.dataclass
class LightRig:
    """The reference scene's standard three-light setup (Main.cpp:101-131)."""

    point: PointLight
    directional: DirectionalLight
    spot: Spotlight

    @staticmethod
    def default() -> "LightRig":
        return LightRig(
            point=PointLight.default(),
            directional=DirectionalLight.default(),
            spot=Spotlight.default(),
        )

    @staticmethod
    def from_numpy(obj, device=None, requires_grad: bool = False) -> "LightRig":
        """From any rig with the same fields (for example the JAX package's
        LightRig), each leaf read as float32 numpy.  With ``device``, each
        leaf becomes a float32 tensor there instead, a leaf of autograd
        that requires grad when ``requires_grad``."""
        def leaf(v):
            a = np.array(np.asarray(v), dtype=np.float32)
            if device is None:
                return a
            return torch.from_numpy(a).to(device).requires_grad_(requires_grad)

        def conv(src, cls):
            return cls(**{f.name: leaf(getattr(src, f.name)) for f in dataclasses.fields(cls)})

        return LightRig(point=conv(obj.point, PointLight),
                        directional=conv(obj.directional, DirectionalLight),
                        spot=conv(obj.spot, Spotlight))

    @staticmethod
    def from_vector(v) -> "LightRig":
        """A rig whose leaves are slices of ``v`` (f32[50] in VECTOR_LAYOUT
        order; a tensor's slices are views, so a gradient reaches ``v``)."""
        fields: dict = {"point": {}, "directional": {}, "spot": {}}
        i = 0
        for lt, f, w in VECTOR_LAYOUT:
            fields[lt][f] = v[i:i + w] if w > 1 else v[i].reshape(())
            i += w
        return LightRig(point=PointLight(**fields["point"]),
                        directional=DirectionalLight(**fields["directional"]),
                        spot=Spotlight(**fields["spot"]))

    def leaves(self) -> list:
        """The 22 leaves in VECTOR_LAYOUT order."""
        return [getattr(getattr(self, lt), f) for lt, f, _ in VECTOR_LAYOUT]

    def _tensors(self) -> list:
        """The leaves that are tensors (one pass over the lights' fields: it
        runs on every shading call)."""
        return [v for light in (self.point, self.directional, self.spot)
                for v in vars(light).values()
                if not isinstance(v, _HOST) and isinstance(v, torch.Tensor)]

    @property
    def requires_grad(self) -> bool:
        return any(v.requires_grad for v in self._tensors())

    @property
    def on_card(self) -> bool:
        """True when a leaf is a CUDA tensor."""
        return any(v.is_cuda for v in self._tensors())

    def to_vector(self) -> np.ndarray:
        """The rig as host float32[50] in VECTOR_LAYOUT order (csrc/shade.cu);
        tensor leaves are read back."""
        parts = []
        for lt, f, w in VECTOR_LAYOUT:
            v = getattr(getattr(self, lt), f)
            if not isinstance(v, _HOST) and isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            parts.append(np.asarray(v, np.float32).reshape(w))
        return np.concatenate(parts)

    def to_tensor(self, device) -> torch.Tensor:
        """The rig as float32[50] in VECTOR_LAYOUT order on ``device``:
        tensor leaves are stacked there (differentiably, with no read
        back), host leaves go up with them."""
        device = torch.device(device)
        if not self._tensors():
            return torch.from_numpy(self.to_vector()).to(device)
        return torch.cat([
            (v.to(device=device, dtype=torch.float32) if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v, np.float32)).to(device)).reshape(w)
            for v, (_, _, w) in zip(self.leaves(), VECTOR_LAYOUT)])

    def shade(self, n, p, eye, diffuse, specular, shininess, shadow):
        c = shade_point_light(self.point, n, p, eye, diffuse, specular, shininess, shadow)
        c = c + shade_directional_light(
            self.directional, n, p, eye, diffuse, specular, shininess, shadow
        )
        c = c + shade_spotlight(self.spot, n, p, eye, diffuse, specular, shininess, shadow)
        return c


__all__ = [
    "PointLight",
    "DirectionalLight",
    "Spotlight",
    "LightRig",
    "VECTOR_LAYOUT",
    "host_leaf",
    "shade_point_light",
    "shade_directional_light",
    "shade_spotlight",
]
