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

The int8 conv (``conv2d_int8``, ``layers.py:103-146``) quantizes the
activation in f32, runs the s8 x s8 -> s32 convolution ``ops.conv_s8``
(the hand-written kernel on the card; never ``F.conv2d``) and dequantizes
as ``acc * (ascale * wscale)`` in f32 before the cast to the compute dtype.
``conv_any`` (``layers.py:149-170``) dispatches on the weight: a ``QConv``
site runs ``conv2d_int8``, a float weight ``conv2d``; ``conv_bn`` and
``conv_dw`` go through it, so quantizing a model's weights
(``quantize_arcface``, ``quantize_detector``) switches its precision
without touching its forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facekit_torch.ops.conv_s8 import conv_s8

BN_EPS = 1e-5


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1,
           bias: Optional[torch.Tensor] = None,
           dilation: int = 1) -> torch.Tensor:
    """NHWC conv with OIHW weights and symmetric padding."""
    xc = x.permute(0, 3, 1, 2)
    if bias is None:
        out = F.conv2d(xc, w.to(x.dtype), stride=stride, padding=padding,
                       groups=groups, dilation=dilation)
    else:
        out = F.conv2d(xc.float(), w.to(x.dtype).float(), stride=stride,
                       padding=padding, groups=groups, dilation=dilation)
        out = (out + bias.float()[None, :, None, None]).to(x.dtype)
    return out.permute(0, 2, 3, 1)


def quantize_conv_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of an OIHW weight
    (``facekit/models/layers.py:92-100``, there over HWIO's axes 0, 1, 2):
    f32 amax over (I, H, W), scale = max(amax, 1e-12) / 127, q =
    clip(round(w / scale), -127, 127). Returns (int8 OIHW, (O,) f32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def conv2d_int8(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                stride: int = 1, padding: int = 0, groups: int = 1,
                ascale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 conv of an NHWC tensor with an int8 OIHW weight and its (O,)
    scales, dequantized with (activation scale * weight scale); ``groups``
    1 or C (depthwise, weight (C, 1, KH, KW)).

    ``ascale`` None: the activation scale is dynamic, per sample:
    max(amax over (H, W, C), 1e-12) / 127, so a sample's result does not
    depend on its batch neighbours. Otherwise it is the calibrated f32
    scalar. Returns the compute dtype of ``x``.
    """
    if ascale is None:
        amax = x.float().abs().amax(dim=(1, 2, 3), keepdim=True)
        ascale = torch.clamp_min(amax, 1e-12) / 127.0
    else:
        ascale = ascale.float()
    # a true division and round half to even, as layers.py:135-136
    xq = torch.clamp(torch.round(x.float() / ascale), -127, 127)
    # OIHW -> (O, KH, KW, I): a view when wq is stored channels-last
    acc = conv_s8(xq.to(torch.int8), wq.permute(0, 2, 3, 1), stride=stride,
                  padding=padding, groups=groups)
    out = acc.float() * (ascale * wscale.float())
    return out.to(x.dtype)


class QConv(nn.Module):
    """An int8 conv site: ``q`` int8 OIHW (stored channels-last, so that
    its (O, KH, KW, I) view is contiguous for the kernel), ``scale`` (O,)
    f32 per output channel and, when calibrated, ``ascale`` the f32 scalar
    activation scale."""

    def __init__(self, o: int, i: int, k: int, calibrated: bool):
        super().__init__()
        self.register_buffer("q", torch.zeros(
            (o, i, k, k), dtype=torch.int8).contiguous(
                memory_format=torch.channels_last))
        self.register_buffer("scale", torch.ones(o))
        self.register_buffer("ascale",
                             torch.ones(()) if calibrated else None)


def conv_any(x: torch.Tensor, w, stride: int = 1, padding: int = 0,
             groups: int = 1) -> torch.Tensor:
    """Dispatch on the site: a ``QConv`` runs ``conv2d_int8``, a float
    OIHW weight ``conv2d``."""
    if isinstance(w, QConv):
        return conv2d_int8(x, w.q, w.scale, stride=stride, padding=padding,
                           groups=groups, ascale=w.ascale)
    return conv2d(x, w, stride=stride, padding=padding, groups=groups)


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


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


def nearest_resize_to(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') to an explicit size (NHWC)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = torch.tensor((np.arange(oh) * h) // oh, device=x.device)
    cols = torch.tensor((np.arange(ow) * w) // ow, device=x.device)
    return x[:, rows][:, :, cols]


class BatchNorm(nn.Module):
    """Inference BN over the last axis, facekit's parametrization."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        return batch_norm(x, self.scale, self.bias, self.mean, self.var)


def conv_bn(x: torch.Tensor, w, bn: BatchNorm, stride: int = 1,
            padding: int = 1, act: str = "relu", leaky_slope: float = 0.0,
            groups: int = 1) -> torch.Tensor:
    """conv -> BN -> (relu | leaky | none), the reference's conv_bn family
    (``conversion/retina/models/net.py:9-38``); ``w`` a float weight or a
    ``QConv``."""
    x = bn(conv_any(x, w, stride=stride, padding=padding, groups=groups))
    if act == "relu":
        x = relu(x)
    elif act == "leaky":
        x = leaky_relu(x, leaky_slope)
    return x


def conv_dw(x: torch.Tensor, dw_w, dw_bn: BatchNorm, pw_w, pw_bn: BatchNorm,
            stride: int) -> torch.Tensor:
    """Depthwise-separable unit: dw3x3 (``groups`` = C) + BN + ReLU, then
    pw1x1 + BN + ReLU (``conversion/retina/models/net.py:29-38``); each
    weight float or a ``QConv``."""
    x = relu(dw_bn(conv_any(x, dw_w, stride=stride, padding=1,
                            groups=x.shape[-1])))
    return relu(pw_bn(conv_any(x, pw_w)))
