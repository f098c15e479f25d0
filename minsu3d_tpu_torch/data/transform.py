"""Point-cloud augmentations (host-side NumPy): the port's copy of
minsu3d_tpu/data/transform.py, the same draws in the same order from the
``np.random.Generator`` each function takes.

Semantics of reference minsu3d/util/transform.py:6-99: 3x3 jitter/flip/rot
matrices, two-pass elastic distortion (box-blurred random noise grids,
trilinear interpolation), and the shrinking-window spatial crop.
"""

from __future__ import annotations

import numpy as np


def jitter_mat(rng: np.random.Generator, intensity: float = 0.1) -> np.ndarray:
    """Random linear jitter: I + N(0, intensity) per element (ref transform.py:6-13)."""
    return np.eye(3) + rng.standard_normal((3, 3)) * intensity


def flip_mat(rng: np.random.Generator, axis: int = 0, random: bool = True) -> np.ndarray:
    """Sign flip of one axis, optionally randomized (ref transform.py:16-26)."""
    m = np.eye(3)
    m[axis][axis] *= (rng.integers(0, 2) * 2 - 1) if random else -1
    return m


def rotz_mat(t: float) -> np.ndarray:
    """CCW rotation about z (ref transform.py:52-60)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _box_blur_axis(a: np.ndarray, axis: int) -> np.ndarray:
    """3-tap box blur with zero ('constant') boundary, matching
    scipy.ndimage.convolve(mode='constant') as used at ref transform.py:65-77."""
    p = np.zeros_like(a)
    lead = [slice(None)] * a.ndim
    lag = [slice(None)] * a.ndim
    lead[axis] = slice(1, None)
    lag[axis] = slice(None, -1)
    p += a
    p[tuple(lag)] += a[tuple(lead)]
    p[tuple(lead)] += a[tuple(lag)]
    return p / 3.0


def elastic(x: np.ndarray, gran: float, mag: float, rng: np.random.Generator) -> np.ndarray:
    """Elastic distortion (ref transform.py:65-83): per-axis noise grids at
    granularity ``gran``, blurred twice along each axis, sampled trilinearly."""
    bb = (np.abs(x).max(0) // gran + 3).astype(np.int32)
    noise = [rng.standard_normal(tuple(bb)).astype(np.float32) for _ in range(3)]
    for _ in range(2):
        for axis in range(3):
            noise = [_box_blur_axis(n, axis) for n in noise]

    # grid axes: linspace(-(b-1)*gran, (b-1)*gran, b) => spacing 2*gran
    origin = -(bb - 1) * gran
    g = (x - origin) / (2.0 * gran)  # fractional grid coords
    g0 = np.floor(g).astype(np.int64)
    frac = (g - g0).astype(np.float32)

    disp = np.empty_like(x, dtype=np.float32)
    for d in range(3):
        n = noise[d]
        acc = np.zeros(len(x), np.float32)
        for cx in (0, 1):
            wx_i = np.clip(g0[:, 0] + cx, 0, bb[0] - 1)
            wx = frac[:, 0] if cx else 1 - frac[:, 0]
            in_x = (g0[:, 0] + cx >= 0) & (g0[:, 0] + cx < bb[0])
            for cy in (0, 1):
                wy_i = np.clip(g0[:, 1] + cy, 0, bb[1] - 1)
                wy = frac[:, 1] if cy else 1 - frac[:, 1]
                in_y = (g0[:, 1] + cy >= 0) & (g0[:, 1] + cy < bb[1])
                for cz in (0, 1):
                    wz_i = np.clip(g0[:, 2] + cz, 0, bb[2] - 1)
                    wz = frac[:, 2] if cz else 1 - frac[:, 2]
                    in_z = (g0[:, 2] + cz >= 0) & (g0[:, 2] + cz < bb[2])
                    w = wx * wy * wz * (in_x & in_y & in_z)  # out-of-bounds -> 0 fill
                    acc += w.astype(np.float32) * n[wx_i, wy_i, wz_i]
        disp[:, d] = acc
    return x + disp * mag


def crop(pc: np.ndarray, max_num_point: int, scale: int, rng: np.random.Generator):
    """Shrinking-window crop to at most ``max_num_point`` points
    (ref transform.py:86-99). Returns (offset_points, valid_mask)."""
    pc_offset = pc.copy()
    valid_idxs = pc_offset.min(1) >= 0
    max_pc_range = np.full(3, scale, dtype=np.float64)
    pc_range = pc.max(0) - pc.min(0)
    while np.count_nonzero(valid_idxs) > max_num_point:
        offset = np.clip(max_pc_range - pc_range + 0.001, None, 0) * rng.random(3)
        pc_offset = pc + offset
        valid_idxs = np.logical_and(pc_offset.min(1) >= 0, np.all(pc_offset < max_pc_range, axis=1))
        max_pc_range[:2] -= 32
    return pc_offset, valid_idxs
