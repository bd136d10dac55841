"""Image resampling as two matrix products, with OpenCV semantics.

Port of the linear part of ``facekit/ops/resize.py:62-105``: a separable
resize is ``out = W_rows @ img @ W_cols^T`` per channel, with OpenCV's
half-pixel source mapping ``src = (dst + 0.5) * in/out - 0.5``, a 2-tap
triangle kernel and border replication by index clamping. It serves
``embed_cropped`` on a crop that is not the recognizer's input size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resize_matrix(in_size: int, out_size: int, method: str = "linear",
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense (out_size, in_size) linear interpolation matrix for one axis."""
    if method != "linear":
        raise ValueError(f"resize method {method!r} is not ported yet "
                         "(only 'linear')")
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src)
    frac = src - base
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for t in (0, 1):
        idx = np.clip(base + t, 0, in_size - 1).astype(np.int64)
        wt = np.maximum(1.0 - np.abs(t - frac), 0.0)
        np.add.at(w, (np.arange(out_size), idx), wt)
    return torch.tensor(w, dtype=dtype, device=device)


def saturate_uint8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's uint8 output: round half to even, clamp to [0, 255]."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def resize_image(img: torch.Tensor, out_hw: Tuple[int, int],
                 method: str = "linear", saturate: bool = False
                 ) -> torch.Tensor:
    """Resize an (H, W, C) or (N, H, W, C) image with OpenCV semantics."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    _, h, w, _ = img.shape
    oh, ow = out_hw
    wr = resize_matrix(h, oh, method, device=img.device)
    wc = resize_matrix(w, ow, method, device=img.device)
    out = torch.einsum("oh,nhwc->nowc", wr, img.float())
    out = torch.einsum("pw,nowc->nopc", wc, out)
    if saturate:
        out = saturate_uint8(out)
    return out[0] if squeeze else out
