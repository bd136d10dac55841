"""ArcFace margin heads, the port of ``facekit/train/arcface_head.py``.

The class-center matrix ``{"w": (C, D)}`` and two margin heads on f32
tensors: ``arc_margin_logits`` (additive angular margin with the
easy-margin fallback, ``:27-49``) and ``combined_margin_logits`` (the
insightface (m1, m2, m3) margin, ``:52-86``). Plain functions that
autograd differentiates; the train step runs them in f32 whatever the
backbone's compute dtype.

The data-parallel step computes a block of the head's classes at a
time: ``cosines``, ``onehot`` (with the block's first class) and the
element-wise ``arc_margin`` / ``combined_margin`` give that block's
columns of the same logits.

``head_init`` draws from a ``torch.Generator`` or a numpy ``Generator``;
facekit draws from a PRNGKey, so the two packages' heads agree only when
one numpy-drawn head is given to both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def head_init(num_classes: int, embed_dim: int = 512, generator=None,
              device=None) -> Dict[str, torch.Tensor]:
    """``{"w": normal(0, 1) * 0.01}`` of shape (num_classes, embed_dim),
    f32, drawn from ``generator``: a ``torch.Generator`` (CPU), a numpy
    ``Generator``, or None for torch's global one."""
    shape = (num_classes, embed_dim)
    if isinstance(generator, np.random.Generator):
        w = torch.from_numpy(generator.normal(size=shape).astype(np.float32))
    else:
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
    w = w * 0.01
    return {"w": w if device is None else w.to(device)}


def cosines(head: Dict[str, torch.Tensor], embeddings: torch.Tensor
            ) -> torch.Tensor:
    """(B, C) cosines of the embeddings with the L2-normed class centers,
    clipped to (-1 + 1e-7, 1 - 1e-7). Row by row: a block of the head's
    rows gives the same columns of the whole head's cosines."""
    w = head["w"]
    wn = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
    return torch.clamp(embeddings @ wn.T, -1.0 + 1e-7, 1.0 - 1e-7)


def onehot(labels: torch.Tensor, num_classes: int, like: torch.Tensor,
           first: Optional[int] = None) -> torch.Tensor:
    """(B, num_classes) one-hot targets in ``like``'s dtype. With
    ``first``, of the block of classes ``first`` ... ``first +
    num_classes - 1`` of a larger head: a row of zeros for a label
    outside it."""
    if first is None:
        return F.one_hot(labels.long(), num_classes).to(like.dtype)
    cols = torch.arange(first, first + num_classes, device=labels.device)
    return (labels.long()[:, None] == cols[None, :]).to(like.dtype)


def arc_margin_logits(head: Dict[str, torch.Tensor], embeddings: torch.Tensor,
                      labels: torch.Tensor, margin: float = 0.5,
                      scale: float = 64.0) -> torch.Tensor:
    """(B, D) L2-normed embeddings + (B,) labels -> (B, C) margined logits:
    cos(theta + m) on the target class only; where theta + m exceeds pi,
    the linear penalty cos - sin(pi - m) * m."""
    cos = cosines(head, embeddings)
    return arc_margin(cos, onehot(labels, head["w"].shape[0], cos), margin,
                      scale)


def arc_margin(cos: torch.Tensor, target: torch.Tensor, margin: float = 0.5,
               scale: float = 64.0) -> torch.Tensor:
    """``arc_margin_logits`` from the cosines and the one-hot targets:
    element by element, so the columns of a block of classes are those
    of the whole head's logits."""
    sin = torch.sqrt(1.0 - cos ** 2)
    # facekit takes these in f32 (jnp.cos of a Python float)
    cos_m = float(np.cos(np.float32(margin)))
    sin_m = float(np.sin(np.float32(margin)))
    phi = cos * cos_m - sin * sin_m
    th = float(np.cos(np.float32(math.pi - margin)))
    mm = float(np.float32(np.sin(np.float32(math.pi - margin)) *
                          np.float32(margin)))
    phi = torch.where(cos > th, phi, cos - mm)
    return scale * (target * phi + (1.0 - target) * cos)


def combined_margin_logits(head: Dict[str, torch.Tensor],
                           embeddings: torch.Tensor, labels: torch.Tensor,
                           m1: float = 1.0, m2: float = 0.5, m3: float = 0.0,
                           scale: float = 64.0) -> torch.Tensor:
    """Target logit cos(m1 * theta + m2) - m3: (1, m, 0) ArcFace, (1, 0, m)
    CosFace, (m, 0, 0) SphereFace. Past theta = (pi - m2) / m1, an
    additive triple (m1 == 1) takes the linear penalty cos - sin(m2) * m2
    - m3, which keeps a gradient, and a multiplicative one clips the angle
    at pi, which keeps the logit monotone in theta."""
    cos = cosines(head, embeddings)
    return combined_margin(cos, onehot(labels, head["w"].shape[0], cos), m1,
                           m2, m3, scale)


def combined_margin(cos: torch.Tensor, target: torch.Tensor, m1: float = 1.0,
                    m2: float = 0.5, m3: float = 0.0, scale: float = 64.0
                    ) -> torch.Tensor:
    """``combined_margin_logits`` from the cosines and the one-hot
    targets, element by element as ``arc_margin``."""
    theta = torch.arccos(cos)
    if m1 == 1.0:
        phi = torch.cos(theta + m2) - m3
        th = math.cos(math.pi - m2)
        mm = math.sin(m2) * m2
        phi = torch.where(cos > th, phi, cos - mm - m3)
    else:
        phi = torch.cos(torch.clamp(m1 * theta + m2, 0.0, math.pi)) - m3
    return scale * (target * phi + (1.0 - target) * cos)
