"""ArcFace IR/IR-SE backbones as ``nn.Module``s, float path.

Port of ``facekit/models/arcface.py`` (face.evoLVe family): the block
specs (``:39-48``), the SE mean in f32 (``:59-63``), the IR block
(``:99-118``) and the forward (``:269-301``): the head flattens in NCHW
order so torch-layout Linear weights apply unchanged, and the embedding is
L2-normalized in f32 with the norm clamped at 1e-12.

Parameter names follow facekit's pytree paths (``input.conv``,
``blocks.3.shortcut.bn.scale``, ``output.linear.w``), so
``weights.bridge.from_jax`` maps one onto the other.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from facekit_torch.models import layers as L

ARCFACE_STAGE_UNITS = {
    "ir_50": (3, 4, 14, 3),
    "ir_101": (3, 13, 30, 3),
    "ir_152": (3, 8, 36, 3),
    # facekit-only miniature for tests (not in the reference family)
    "ir_tiny": (1, 1, 1, 1),
}
_STAGE_DEPTHS = (64, 128, 256, 512)


def block_specs(network: str) -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck; ``ir_se_*`` shares its
    ``ir_*`` specs."""
    units = ARCFACE_STAGE_UNITS[network.replace("ir_se", "ir")]
    specs = []
    in_c = 64
    for depth, n in zip(_STAGE_DEPTHS, units):
        specs.append((in_c, depth, 2))
        specs.extend((depth, depth, 1) for _ in range(n - 1))
        in_c = depth
    return specs


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class BatchNorm(nn.Module):
    """Inference BN over the last axis, facekit's parametrization."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        return L.batch_norm(x, self.scale, self.bias, self.mean, self.var)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _weight(64, 3, 3, 3)
        self.bn = BatchNorm(64)
        self.prelu = _weight(64)

    def forward(self, x):
        x = L.conv2d(x, self.conv, stride=1, padding=1)
        return L.prelu(self.bn(x), self.prelu)


class _Shortcut(nn.Module):
    def __init__(self, in_c: int, depth: int):
        super().__init__()
        self.conv = _weight(depth, in_c, 1, 1)
        self.bn = BatchNorm(depth)


class _SE(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = _weight(channels // reduction, channels, 1, 1)
        self.fc2 = _weight(channels, channels // reduction, 1, 1)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        s = L.relu(L.conv2d(s, self.fc1))
        s = torch.sigmoid(L.conv2d(s, self.fc2))
        return x * s


class IRBlock(nn.Module):
    """bottleneck_IR(-SE): shortcut = subsample or conv1x1(stride)+BN;
    residual = BN -> conv3x3 -> PReLU -> conv3x3(stride) -> BN [-> SE]."""

    def __init__(self, in_c: int, depth: int, stride: int, se: bool):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(in_c)
        self.conv1 = _weight(depth, in_c, 3, 3)
        self.prelu = _weight(depth)
        self.conv2 = _weight(depth, depth, 3, 3)
        self.bn2 = BatchNorm(depth)
        self.shortcut = _Shortcut(in_c, depth) if in_c != depth else None
        self.se = _SE(depth) if se else None

    def forward(self, x):
        if self.shortcut is not None:
            sc = L.conv2d(x, self.shortcut.conv, stride=self.stride)
            sc = self.shortcut.bn(sc)
        else:
            sc = L.strided_identity(x, self.stride)
        r = self.bn1(x)
        r = L.conv2d(r, self.conv1, stride=1, padding=1)
        r = L.prelu(r, self.prelu)
        r = L.conv2d(r, self.conv2, stride=self.stride, padding=1)
        r = self.bn2(r)
        if self.se is not None:
            r = self.se(r)
        return r + sc


class _Linear(nn.Module):
    def __init__(self, out_f: int, in_f: int):
        super().__init__()
        self.w = _weight(out_f, in_f)
        self.b = _weight(out_f)


class _Head(nn.Module):
    def __init__(self, fmap: int, embed_dim: int):
        super().__init__()
        self.bn2d = BatchNorm(512)
        self.linear = _Linear(embed_dim, 512 * fmap * fmap)
        self.bn1d = BatchNorm(embed_dim)

    def forward(self, x):
        x = self.bn2d(x)
        # torch flattens NCHW; permute so torch-layout Linear weights apply
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        x = L.linear(x, self.linear.w, self.linear.b)
        x = self.bn1d(x).float()
        # torch F.normalize clamps the denominator at eps=1e-12
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.clamp_min(norm, 1e-12)


class ArcFace(nn.Module):
    """(N, H, W, 3) normalized RGB -> (N, embed_dim) L2-normalized f32."""

    def __init__(self, network: str = "ir_50", input_size: int = 112,
                 embed_dim: int = 512):
        super().__init__()
        self.network = network
        self.compute_dtype = torch.float32
        se = network.startswith("ir_se")
        self.input = _Stem()
        self.blocks = nn.ModuleList(
            IRBlock(in_c, depth, stride, se)
            for in_c, depth, stride in block_specs(network))
        self.output = _Head(input_size // 16, embed_dim)

    def set_compute_dtype(self, dtype: torch.dtype) -> "ArcFace":
        """Compute in ``dtype``. Stores in that dtype the weights facekit
        casts to it before use (conv and linear weights, PReLU slopes);
        BN parameters and the linear bias stay f32, as facekit computes
        with them in f32. Returns self."""
        self.compute_dtype = dtype
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2 or leaf == "prelu":
                p.data = p.data.to(dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input(x.to(self.compute_dtype))
        for blk in self.blocks:
            x = blk(x)
        return self.output(x)
