"""Small 4x4 transform helpers (look-at, orthographic, perspective).

Equivalents of the GLM calls the reference leans on (glm::lookAt,
glm::ortho, glm::perspective — src/Camera.cpp, src/Light.cpp), needed here
only for the projective shadow-map path and image-space utilities.
Row-vector-free convention: matrices act on column vectors, numpy float32.
"""

from __future__ import annotations

import numpy as np


def _norm(v):
    return v / np.linalg.norm(v)


def look_at(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, dtype=np.float64)
    f = _norm(np.asarray(center, dtype=np.float64) - eye)
    s = _norm(np.cross(f, np.asarray(up, dtype=np.float64)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


def ortho(left, right, bottom, top, near, far) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -2.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    return m.astype(np.float32)


