"""Anchor (prior box) generation for the detectors (``facekit/ops/anchors.py``).

The reference's ``create_anchor_retinaface`` (``src/retinaface.cpp:
210-240``): three FPN levels with strides (8, 16, 32) and min sizes
((10, 20), (32, 64), (128, 256)), two anchors per cell, ordered by
row-major cell then min size, which is the heads' output order. A = 3,780
at 288x320. The slim and RFB detectors use four SSD-style levels at
strides (8, 16, 32, 64) with (3, 2, 2, 3) sizes per cell
(``SLIM_RFB_*``, the reference's ``cfg_slim`` / ``cfg_rfb``): A = 5,295
at 288x320. Anchors depend only on the input geometry, so they are
computed once with numpy and cached.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

RETINAFACE_STEPS: Tuple[int, ...] = (8, 16, 32)
RETINAFACE_MIN_SIZES: Tuple[Tuple[int, ...], ...] = ((10, 20), (32, 64),
                                                     (128, 256))
SLIM_RFB_STEPS: Tuple[int, ...] = (8, 16, 32, 64)
SLIM_RFB_MIN_SIZES: Tuple[Tuple[int, ...], ...] = (
    (10, 16, 24), (32, 48), (64, 96), (128, 192, 256))


@functools.lru_cache(maxsize=16)
def _generate_anchors_np(input_hw: Tuple[int, int], steps: Tuple[int, ...],
                         min_sizes: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    h, w = input_hw
    out = []
    for step, sizes in zip(steps, min_sizes):
        fh = math.ceil(h / step)
        fw = math.ceil(w / step)
        jj, ii, ll = np.meshgrid(np.arange(fw), np.arange(fh),
                                 np.arange(len(sizes)), indexing="xy")
        sizes_arr = np.asarray(sizes, dtype=np.float64)[ll]
        cx = (jj + 0.5) * step / w
        cy = (ii + 0.5) * step / h
        out.append(np.stack([cx, cy, sizes_arr / w, sizes_arr / h],
                            -1).reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def generate_anchors(input_hw: Tuple[int, int],
                     steps: Sequence[int] = RETINAFACE_STEPS,
                     min_sizes: Sequence[Sequence[int]] = RETINAFACE_MIN_SIZES,
                     device=None) -> torch.Tensor:
    """(A, 4) normalized anchors (cx, cy, sx, sy) for the input size."""
    arr = _generate_anchors_np(tuple(input_hw), tuple(steps),
                               tuple(map(tuple, min_sizes)))
    return torch.tensor(arr, device=device)


def num_anchors(input_hw: Tuple[int, int],
                steps: Sequence[int] = RETINAFACE_STEPS,
                min_sizes: Sequence[Sequence[int]] = RETINAFACE_MIN_SIZES
                ) -> int:
    h, w = input_hw
    return sum(math.ceil(h / s) * math.ceil(w / s) * len(m)
               for s, m in zip(steps, min_sizes))
