"""RetinaFace-MobileNetV1x0.25 (FPN + SSH + heads) as an ``nn.Module``.

Port of ``facekit/models/retinaface.py:33-102, 169-212``: the 0.25-width
MobileNetV1 backbone with stages 1-3 tapped as FPN inputs (64/128/256
channels), 1x1 laterals + nearest upsample + 3x3 merges, SSH context
modules (3x3/5x5/7x7 branches, concat + ReLU; the reference's net.py uses
plain ReLU), and 1x1 heads with 2 anchors per cell. The landmark head is
there when the parameters carry it (``with_landmarks``).

(N, H, W, 3) normalized BGR -> loc (N, A, 4), conf (N, A, 2) softmaxed
in f32, ldm (N, A, 10) or None; loc and ldm in f32; A = 3,780 at 288x320.
Parameter names follow facekit's pytree paths (``stem.conv``,
``stage1.0.dw_bn.scale``, ``fpn.merge1.conv``, ``ssh2.conv5x5_1.bn.var``,
``class_head.0.w``), so ``weights.bridge.from_jax`` maps one onto the
other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from facekit_torch.models import layers as L

# (cin, cout, stride) per conv_dw in each stage, after the stem conv_bn
_STAGE1 = [(8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1)]
_STAGE2 = [(64, 128, 2)] + [(128, 128, 1)] * 5
_STAGE3 = [(128, 256, 2), (256, 256, 1)]
_FPN_IN = (64, 128, 256)
_OUT_CH = 64
_NUM_ANCHORS = 2


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__()
        self.conv = _weight(cout, cin, ksize, ksize)
        self.bn = L.BatchNorm(cout)

    def forward(self, x, stride: int = 1, padding: int = 1,
                act: str = "relu"):
        return L.conv_bn(x, self.conv, self.bn, stride=stride,
                         padding=padding, act=act)


class _ConvDW(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dw_conv = _weight(cin, 1, 3, 3)
        self.dw_bn = L.BatchNorm(cin)
        self.pw_conv = _weight(cout, cin, 1, 1)
        self.pw_bn = L.BatchNorm(cout)

    def forward(self, x, stride: int):
        return L.conv_dw(x, self.dw_conv, self.dw_bn, self.pw_conv,
                         self.pw_bn, stride)


class _FPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.output1 = _ConvBN(_FPN_IN[0], _OUT_CH, 1)
        self.output2 = _ConvBN(_FPN_IN[1], _OUT_CH, 1)
        self.output3 = _ConvBN(_FPN_IN[2], _OUT_CH, 1)
        self.merge1 = _ConvBN(_OUT_CH, _OUT_CH)
        self.merge2 = _ConvBN(_OUT_CH, _OUT_CH)

    def forward(self, f1, f2, f3):
        o1 = self.output1(f1, padding=0)
        o2 = self.output2(f2, padding=0)
        o3 = self.output3(f3, padding=0)
        o2 = self.merge2(o2 + L.nearest_resize_to(o3, o2.shape[1:3]))
        o1 = self.merge1(o1 + L.nearest_resize_to(o2, o1.shape[1:3]))
        return o1, o2, o3


class _SSH(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv3x3 = _ConvBN(cin, cout // 2)
        self.conv5x5_1 = _ConvBN(cin, cout // 4)
        self.conv5x5_2 = _ConvBN(cout // 4, cout // 4)
        self.conv7x7_2 = _ConvBN(cout // 4, cout // 4)
        self.conv7x7_3 = _ConvBN(cout // 4, cout // 4)

    def forward(self, x):
        c3 = self.conv3x3(x, act="none")
        c5_1 = self.conv5x5_1(x)
        c5 = self.conv5x5_2(c5_1, act="none")
        c7 = self.conv7x7_3(self.conv7x7_2(c5_1), act="none")
        return L.relu(torch.cat([c3, c5, c7], dim=-1))


class _Head(nn.Module):
    """A biased 1x1 conv: ``w`` (2*dim, cin, 1, 1), ``b`` (2*dim,) f32."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.dim = dim
        self.w = _weight(_NUM_ANCHORS * dim, cin, 1, 1)
        self.b = _weight(_NUM_ANCHORS * dim)

    def forward(self, x):
        out = L.conv2d(x, self.w, bias=self.b)
        n, h, w, _ = out.shape
        return out.reshape(n, h * w * _NUM_ANCHORS, self.dim)


class RetinaFace(nn.Module):
    """RetinaFace-MobileNet0.25; see the module docstring."""

    def __init__(self, with_landmarks: bool = True):
        super().__init__()
        self.compute_dtype = torch.float32
        self.stem = _ConvBN(3, 8)
        self.stage1 = nn.ModuleList(_ConvDW(ci, co) for ci, co, _ in _STAGE1)
        self.stage2 = nn.ModuleList(_ConvDW(ci, co) for ci, co, _ in _STAGE2)
        self.stage3 = nn.ModuleList(_ConvDW(ci, co) for ci, co, _ in _STAGE3)
        self.fpn = _FPN()
        self.ssh1 = _SSH(_OUT_CH, _OUT_CH)
        self.ssh2 = _SSH(_OUT_CH, _OUT_CH)
        self.ssh3 = _SSH(_OUT_CH, _OUT_CH)
        self.class_head = nn.ModuleList(_Head(_OUT_CH, 2) for _ in range(3))
        self.bbox_head = nn.ModuleList(_Head(_OUT_CH, 4) for _ in range(3))
        self.ldm_head = (nn.ModuleList(_Head(_OUT_CH, 10) for _ in range(3))
                         if with_landmarks else None)

    def set_compute_dtype(self, dtype: torch.dtype) -> "RetinaFace":
        """Compute in ``dtype``; conv weights are stored in it (facekit
        casts them before use), BN parameters and head biases stay f32.
        Returns self."""
        self.compute_dtype = dtype
        for p in self.parameters():
            if p.dim() == 4:
                p.data = p.data.to(dtype)
        return self

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        x = self.stem(x.to(self.compute_dtype), stride=2)
        feats = []
        for stage, spec in ((self.stage1, _STAGE1), (self.stage2, _STAGE2),
                            (self.stage3, _STAGE3)):
            for unit, (_, _, stride) in zip(stage, spec):
                x = unit(x, stride)
            feats.append(x)
        o1, o2, o3 = self.fpn(*feats)
        feats = [self.ssh1(o1), self.ssh2(o2), self.ssh3(o3)]

        loc = torch.cat([h(f) for f, h in zip(feats, self.bbox_head)], 1)
        logits = torch.cat([h(f) for f, h in zip(feats, self.class_head)], 1)
        conf = torch.softmax(logits.float(), dim=-1)
        ldm = None
        if self.ldm_head is not None:
            ldm = torch.cat([h(f) for f, h in zip(feats, self.ldm_head)],
                            1).float()
        return loc.float(), conf, ldm
