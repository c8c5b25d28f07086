"""Shape normalizers (parity: gravomg_bindings/src/gravomg/util.py:46-69)."""

from __future__ import annotations

import numpy as np


def face_area(pos: np.ndarray, F: np.ndarray) -> np.ndarray:
    v1, v2, v3 = pos[F[:, 0]], pos[F[:, 1]], pos[F[:, 2]]
    return np.linalg.norm(np.cross(v2 - v1, v3 - v1), axis=1) / 2


def normalize_area(pos: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Scale to unit total surface area and center at the origin."""
    pos = pos / np.sqrt(face_area(pos, F).sum())
    return pos - np.mean(pos, axis=0, keepdims=True)


def normalize_bounding_box(pos: np.ndarray) -> np.ndarray:
    """Center and scale so the bounding box fits in [-0.5, 0.5]^3."""
    pos = pos - pos.mean(axis=0, keepdims=True)
    return pos * (0.5 / np.abs(pos).max())


def normalize_axes(pos: np.ndarray) -> np.ndarray:
    """Permute axes by increasing standard deviation."""
    return pos[:, np.argsort(np.std(pos, axis=0))]
