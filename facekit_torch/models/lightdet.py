"""The slim and RFB light face detectors as an ``nn.Module``.

Port of ``facekit/models/lightdet.py:20-190`` (the reference's
``net_slim.py`` / ``net_rfb.py``): ``conv1`` conv_bn(3, 16, stride 2),
then a chain of twelve depthwise-separable units (conv2-conv13; in RFB
the seventh, conv8, is a ``BasicRFB`` block with branches dilated by 2, 3
and 5), then ``conv14`` = biased 1x1 (256 -> 64) + ReLU + a biased
depthwise-separable 3x3 stride 2 + ReLU. Four levels (after conv8,
conv11, conv13 and conv14; strides 8, 16, 32, 64) feed the heads with
(3, 2, 2, 3) anchors a cell: a biased depthwise-separable 3x3 on levels
0-2 and a plain biased 3x3 on level 3. The landmark heads are always
there.

(N, H, W, 3) normalized BGR -> loc (N, A, 4), conf (N, A, 2) softmaxed in
f32, ldm (N, A, 10), loc and ldm in f32; A = 5,295 at 288x320 (anchors
``ops.anchors.SLIM_RFB_*``). Parameter names follow facekit's pytree
paths (``conv1.conv``, ``dw.3.pw_bn.var``, ``rfb8.b2.3.w``, ``loc.3.b``),
so ``weights.bridge.from_jax`` maps one onto the other; RFB has no
``dw.6`` (facekit holds ``None`` there).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from facekit_torch.models import layers as L
from facekit_torch.models.retinaface import _ConvBN, _ConvDW, _weight

# (cin, cout, stride) of conv2..conv13; index 6 (conv8) is RFB's block
DW_CHAIN = [(16, 32, 1), (32, 32, 2), (32, 32, 1), (32, 64, 2),
            (64, 64, 1), (64, 64, 1), (64, 64, 1),          # conv2..conv8
            (64, 128, 2), (128, 128, 1), (128, 128, 1),     # conv9..conv11
            (128, 256, 2), (256, 256, 1)]                   # conv12..conv13
RFB_INDEX = 6
LEVEL_CH = (64, 128, 256, 256)
LEVEL_ANCHORS = (3, 2, 2, 3)
_FEATURE_AFTER = (6, 9, 11)          # the chain's outputs the heads read
VARIANTS = ("slim", "rfb")


class _DepthConv(nn.Module):
    """The reference's ``depth_conv2d``: a biased depthwise conv, ReLU, a
    biased 1x1 (``net_slim.py:15-20``)."""

    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__()
        self.dw_w = _weight(cin, 1, ksize, ksize)
        self.dw_b = _weight(cin)
        self.pw_w = _weight(cout, cin, 1, 1)
        self.pw_b = _weight(cout)

    def forward(self, x, stride: int = 1, padding: int = 0):
        x = L.conv2d(x, self.dw_w, stride=stride, padding=padding,
                     groups=x.shape[-1], bias=self.dw_b)
        return L.conv2d(L.relu(x), self.pw_w, bias=self.pw_b)


class _BiasedConv(nn.Module):
    def __init__(self, cout: int, cin: int, ksize: int):
        super().__init__()
        self.w = _weight(cout, cin, ksize, ksize)
        self.b = _weight(cout)

    def forward(self, x, padding: int = 0):
        return L.conv2d(x, self.w, padding=padding, bias=self.b)


class _BasicConv(nn.Module):
    """``BasicConv``: conv (no bias) + BN (+ ReLU); every conv of
    ``BasicRFB`` carries its BN (``facekit/models/lightdet.py:68-86``)."""

    def __init__(self, cin: int, cout: int, ksize: int):
        super().__init__()
        self.w = _weight(cout, cin, ksize, ksize)
        self.bn = L.BatchNorm(cout)

    def forward(self, x, padding: int = 0, dilation: int = 1,
                act: bool = True):
        x = self.bn(L.conv2d(x, self.w, padding=padding, dilation=dilation))
        return L.relu(x) if act else x


class _RFB(nn.Module):
    """``BasicRFB(cin, cout, scale=1.0)`` with map_reduce 8 and vision 1
    (``facekit/models/lightdet.py:68-104``)."""

    def __init__(self, cin: int, cout: int, map_reduce: int = 8):
        super().__init__()
        inter = cin // map_reduce
        self.b0 = nn.ModuleList([_BasicConv(cin, inter, 1),
                                 _BasicConv(inter, 2 * inter, 3),
                                 _BasicConv(2 * inter, 2 * inter, 3)])
        self.b1 = nn.ModuleList([_BasicConv(cin, inter, 1),
                                 _BasicConv(inter, 2 * inter, 3),
                                 _BasicConv(2 * inter, 2 * inter, 3)])
        self.b2 = nn.ModuleList([_BasicConv(cin, inter, 1),
                                 _BasicConv(inter, (inter // 2) * 3, 3),
                                 _BasicConv((inter // 2) * 3, 2 * inter, 3),
                                 _BasicConv(2 * inter, 2 * inter, 3)])
        self.linear = _BasicConv(6 * inter, cout, 1)
        self.shortcut = _BasicConv(cin, cout, 1)

    def forward(self, x, scale: float = 1.0, vision: int = 1):
        # each branch: 1x1 (no ReLU) -> 3x3 convs -> a dilated 3x3 (no ReLU)
        b0, b1, b2 = self.b0, self.b1, self.b2
        y0 = b0[1](b0[0](x, act=False), padding=1)
        y0 = b0[2](y0, padding=vision + 1, dilation=vision + 1, act=False)
        y1 = b1[1](b1[0](x, act=False), padding=1)
        y1 = b1[2](y1, padding=vision + 2, dilation=vision + 2, act=False)
        y2 = b2[2](b2[1](b2[0](x, act=False), padding=1), padding=1)
        y2 = b2[3](y2, padding=vision + 4, dilation=vision + 4, act=False)
        out = self.linear(torch.cat([y0, y1, y2], dim=-1), act=False)
        return L.relu(out * scale + self.shortcut(x, act=False))


def _head(level: int, dim: int) -> nn.Module:
    cout = LEVEL_ANCHORS[level] * dim
    if level < 3:
        return _DepthConv(LEVEL_CH[level], cout)
    return _BiasedConv(cout, LEVEL_CH[level], 3)


class LightDet(nn.Module):
    """The slim or RFB detector; see the module docstring."""

    def __init__(self, variant: str = "slim"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}: 'slim' or 'rfb'")
        self.variant = variant
        self.compute_dtype = torch.float32
        self.conv1 = _ConvBN(3, 16)
        # RFB's conv8 has no parameters under dw: an Identity holds its
        # place, and rfb8 runs there
        self.dw = nn.ModuleList(
            nn.Identity() if variant == "rfb" and i == RFB_INDEX
            else _ConvDW(ci, co) for i, (ci, co, _) in enumerate(DW_CHAIN))
        self.rfb8 = _RFB(64, 64) if variant == "rfb" else None
        self.conv14_a = _BiasedConv(64, 256, 1)
        self.conv14_b = _DepthConv(64, 256)
        self.loc = nn.ModuleList(_head(lvl, 4) for lvl in range(4))
        self.conf = nn.ModuleList(_head(lvl, 2) for lvl in range(4))
        self.landm = nn.ModuleList(_head(lvl, 10) for lvl in range(4))

    def set_compute_dtype(self, dtype: torch.dtype) -> "LightDet":
        """Compute in ``dtype``; conv weights are stored in it (facekit
        casts them before use), BN parameters and biases stay f32.
        Returns self."""
        self.compute_dtype = dtype
        for p in self.parameters():
            if p.dim() == 4:
                p.data = p.data.to(dtype)
        return self

    @staticmethod
    def _heads(heads: nn.ModuleList, feats: List[torch.Tensor],
               dim: int) -> torch.Tensor:
        outs = []
        for level, (f, h) in enumerate(zip(feats, heads)):
            out = h(f, padding=1)
            n, fh, fw, _ = out.shape
            outs.append(out.reshape(n, fh * fw * LEVEL_ANCHORS[level], dim))
        return torch.cat(outs, 1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.conv1(x.to(self.compute_dtype), stride=2)
        feats = []
        for i, (unit, (_, _, stride)) in enumerate(zip(self.dw, DW_CHAIN)):
            if self.rfb8 is not None and i == RFB_INDEX:
                x = self.rfb8(x)
            else:
                x = unit(x, stride)
            if i in _FEATURE_AFTER:
                feats.append(x)
        x = L.relu(self.conv14_a(x))
        feats.append(L.relu(self.conv14_b(x, stride=2, padding=1)))

        loc = self._heads(self.loc, feats, 4)
        conf = torch.softmax(self._heads(self.conf, feats, 2).float(), dim=-1)
        ldm = self._heads(self.landm, feats, 10)
        return loc.float(), conf, ldm.float()
