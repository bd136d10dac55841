"""Pixel normalization for the two model inputs (``facekit/ops/preprocess.py``).

  * detector: BGR image minus channel means (104, 117, 123), stays BGR
    (``src/retinaface.cpp:125-130``);
  * recognizer: BGR -> RGB, then (x - 127.5) * 0.0078125
    (``src/arcface.cpp:105-114``).

Images are NHWC at these boundaries, as in facekit.
"""

from __future__ import annotations

import torch

DET_MEAN_BGR = (104.0, 117.0, 123.0)
REC_SCALE = 0.0078125  # 1/128


def det_normalize(img_bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR uint8/float -> zero-mean float32, BGR order."""
    mean = torch.tensor(DET_MEAN_BGR, dtype=torch.float32, device=img_bgr.device)
    return img_bgr.float() - mean


def rec_normalize(img_bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR uint8/float -> RGB in [-1, 1) float32."""
    rgb = img_bgr.flip(-1)
    return (rgb.float() - 127.5) * REC_SCALE
