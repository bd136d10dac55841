"""NN layers on NHWC tensors, the port of ``facekit/models/layers.py``.

Functions take and return NHWC tensors, as facekit's do, so tests compare
like with like. A conv permutes to an NCHW *view* (channels-last memory,
no copy), runs ``F.conv2d`` and permutes back. Weights are OIHW (torch's
layout; ``weights.bridge.from_jax`` transposes facekit's HWIO).

Rounding follows facekit's, for bf16 compute:
  * an unbiased conv rounds once at its output (f32 accumulation inside
    the conv, ``layers.py:61-89``); a biased one upcasts so that the bias
    adds into the f32 sum before the single rounding;
  * ``batch_norm`` rounds its f32 scale and shift to the input dtype
    before use (``layers.py:176-181``);
  * ``linear`` accumulates in f32, adds the f32 bias and rounds once
    (``layers.py:200-201``); a bf16 ``F.linear`` would round before the
    bias, so it upcasts the operands (exact for bf16) and multiplies in
    f32. With ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's
    default, which the pipeline sets explicitly) that product is full f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC conv with OIHW weights and symmetric padding."""
    xc = x.permute(0, 3, 1, 2)
    if bias is None:
        out = F.conv2d(xc, w.to(x.dtype), stride=stride, padding=padding,
                       groups=groups)
    else:
        out = F.conv2d(xc.float(), w.to(x.dtype).float(), stride=stride,
                       padding=padding, groups=groups)
        out = (out + bias.float()[None, :, None, None]).to(x.dtype)
    return out.permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Inference batch-norm over the last axis (channels)."""
    inv = torch.rsqrt(var.float() + eps)
    s = (scale.float() * inv).to(x.dtype)
    shift = (bias.float() - mean.float() * scale.float() * inv).to(x.dtype)
    return x * s + shift


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over the last axis."""
    return torch.clamp_min(x, 0) + alpha.to(x.dtype) * torch.clamp_max(x, 0)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """w is (out, in) torch layout."""
    out = x.float() @ w.to(x.dtype).float().T
    return (out + b.float()).to(x.dtype)


def strided_identity(x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch MaxPool2d(kernel=1, stride=s): pure subsampling (NHWC)."""
    if stride == 1:
        return x
    return x[:, ::stride, ::stride, :]
