"""ArcFace IR/IR-SE backbones as ``nn.Module``s, float and int8.

Port of ``facekit/models/arcface.py`` (face.evoLVe family): the block
specs (``:39-48``), the SE mean in f32 (``:59-63``), the IR block
(``:99-118``) and the forward (``:269-301``): the head flattens in NCHW
order so torch-layout Linear weights apply unchanged, and the embedding is
L2-normalized in f32 with the norm clamped at 1e-12.

A float block with stride 1, an identity shortcut and no SE (20 of
IR-50's 24) runs as one ``ops.ir_block`` call, the fused kernel on the
card; the other blocks, the calibration forward, and any block whose
output needs a gradient (training: the fused block has no backward, and
facekit trains op by op) run the composition.

Parameter names follow facekit's pytree paths (``input.conv``,
``blocks.3.shortcut.bn.scale``, ``output.linear.w``), so
``weights.bridge.from_jax`` maps one onto the other.

int8 (``quantize_arcface_params``, ``:161-225``): every conv site (the
stem, ``conv1``, ``conv2`` and the shortcut conv of every block) holds a
``QConv`` with facekit's ``{"q", "scale"[, "ascale"]}`` leaves and runs
``layers.conv2d_int8``; BN, PReLU, SE and the head stay float. Without
``ascale`` the activation scales are dynamic, per sample; calibration
(``calibrate_arcface_int8``) folds each site's activation maxima over f32
forwards of the float model and fixes them.

The int8-residual form (``:121-158``, ``int8="residual"``, calibrated
only): the activation between blocks stays s8 with one calibrated f32
scale per block output (``oscale`` on the stem and on every block). A
block dequantizes its s8 input to the compute dtype, runs op by op with
every conv through ``conv2d_int8``, adds the shortcut and quantizes the
sum with its ``oscale``; one dequantization follows the last block. Its
numerics differ from the calibrated form by that one extra 127-level
quantization per block.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from facekit_torch.models import layers as L
from facekit_torch.ops.ir_block import ir_block, needs_grad

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


QConv = L.QConv


INT8_FORMS = (None, "dynamic", "static", "residual")


def _conv_site(o: int, i: int, k: int, int8: Optional[str]):
    """A float OIHW weight, or a ``QConv`` for ``int8`` "dynamic", or
    "static" / "residual" (calibrated)."""
    if int8 is None:
        return _weight(o, i, k, k)
    return QConv(o, i, k, calibrated=int8 in ("static", "residual"))


def _oscale(module: nn.Module, int8: Optional[str]) -> None:
    """The residual form's f32 scale of ``module``'s output."""
    module.register_buffer("oscale",
                           torch.ones(()) if int8 == "residual" else None)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """s8 of ``x`` at ``scale``: clamp(round(x / scale), -127, 127), the
    division in f32 and round half to even (``arcface.py:121-123``)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _conv(x, w, stride: int, padding: int, stats=None, name: str = ""):
    """Dispatch on the site (``facekit/models/arcface.py:85-96``). With
    ``stats`` (calibration) the input's amax is recorded under ``name``,
    the key ``quantize_arcface`` reads the activation scale from."""
    if stats is not None:
        stats[name] = x.float().abs().amax()
    return L.conv_any(x, w, stride=stride, padding=padding)


BatchNorm = L.BatchNorm


class _Stem(nn.Module):
    def __init__(self, int8: Optional[str]):
        super().__init__()
        self.conv = _conv_site(64, 3, 3, int8)
        self.bn = BatchNorm(64)
        self.prelu = _weight(64)
        _oscale(self, int8)

    def forward(self, x, stats=None):
        x = _conv(x, self.conv, stride=1, padding=1, stats=stats,
                  name="input")
        x = L.prelu(self.bn(x), self.prelu)
        if stats is not None:
            stats["stem.out"] = x.float().abs().amax()
        return x


class _Shortcut(nn.Module):
    def __init__(self, in_c: int, depth: int, int8: Optional[str]):
        super().__init__()
        self.conv = _conv_site(depth, in_c, 1, int8)
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

    def __init__(self, in_c: int, depth: int, stride: int, se: bool,
                 int8: Optional[str] = None):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(in_c)
        self.conv1 = _conv_site(depth, in_c, 3, int8)
        self.prelu = _weight(depth)
        self.conv2 = _conv_site(depth, depth, 3, int8)
        self.bn2 = BatchNorm(depth)
        self.shortcut = (_Shortcut(in_c, depth, int8) if in_c != depth
                         else None)
        self.se = _SE(depth) if se else None
        _oscale(self, int8)

    def fusable(self) -> bool:
        """A float block of the form ``ops.ir_block`` computes: stride 1,
        identity shortcut, no SE."""
        return (self.stride == 1 and self.shortcut is None and self.se is None
                and not isinstance(self.conv1, QConv))

    def forward(self, x, stats=None, prefix: str = ""):
        # the calibration forward records the inner conv inputs, which a
        # fused block never holds, so it keeps the composition below, as
        # does a forward that autograd records (the kernel has no backward)
        if stats is None and self.fusable() and not needs_grad(x, self):
            return ir_block(x, self)
        return self.composed(x, stats, prefix)

    def composed(self, x, stats=None, prefix: str = ""):
        """The block op by op, as facekit's ``_block_apply``."""
        if self.shortcut is not None:
            sc = _conv(x, self.shortcut.conv, stride=self.stride, padding=0,
                       stats=stats, name=f"{prefix}.shortcut")
            sc = self.shortcut.bn(sc)
        else:
            sc = L.strided_identity(x, self.stride)
        r = self.bn1(x)
        r = _conv(r, self.conv1, stride=1, padding=1, stats=stats,
                  name=f"{prefix}.conv1")
        r = L.prelu(r, self.prelu)
        r = _conv(r, self.conv2, stride=self.stride, padding=1, stats=stats,
                  name=f"{prefix}.conv2")
        r = self.bn2(r)
        if self.se is not None:
            r = self.se(r)
        out = r + sc
        if stats is not None:
            stats[f"{prefix}.out"] = out.float().abs().amax()
        return out

    def forward_q8(self, xq: torch.Tensor, xs: torch.Tensor,
                   dtype: torch.dtype):
        """The residual form's block (``arcface.py:126-158``): s8 input
        ``xq`` at scale ``xs`` -> (s8 output, its scale ``oscale``)."""
        x = (xq.float() * xs).to(dtype)
        return quantize_act(self.composed(x), self.oscale), self.oscale


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
        x = self.bn1d(x)
        x = x.to(L.acc_dtype(x))
        # torch F.normalize clamps the denominator at eps=1e-12
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.clamp_min(norm, 1e-12)


class ArcFace(nn.Module):
    """(N, H, W, 3) normalized RGB -> (N, embed_dim) L2-normalized f32.

    ``int8``: None (float), "dynamic", "static" (calibrated activation
    scales) or "residual" (calibrated, s8 between blocks): which form the
    conv sites and the blocks take."""

    def __init__(self, network: str = "ir_50", input_size: int = 112,
                 embed_dim: int = 512, int8: Optional[str] = None):
        super().__init__()
        if int8 not in INT8_FORMS:
            raise ValueError(f"int8={int8!r}: one of {INT8_FORMS}")
        self.network = network
        self.input_size = input_size
        self.embed_dim = embed_dim
        self.int8 = int8
        self.compute_dtype = torch.float32
        se = network.startswith("ir_se")
        self.input = _Stem(int8)
        self.blocks = nn.ModuleList(
            IRBlock(in_c, depth, stride, se, int8)
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

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        """``stats``: a dict to record each site's activation amax in (the
        calibration forward, ``arcface_act_amax``)."""
        x = self.input(x.to(self.compute_dtype), stats)
        if self.int8 == "residual":
            # s8 between blocks; one dequantization after the last
            # (arcface.py:276-285)
            xq, xs = quantize_act(x, self.input.oscale), self.input.oscale
            for blk in self.blocks:
                xq, xs = blk.forward_q8(xq, xs, self.compute_dtype)
            x = (xq.float() * xs).to(self.compute_dtype)
        else:
            for i, blk in enumerate(self.blocks):
                x = blk(x, stats, prefix=f"b{i}")
        return self.output(x)


def _sites(net: ArcFace):
    """(site name, parameter key) of every conv site, in facekit's names
    (``arcface.py:207-224``)."""
    yield "input", "input.conv"
    for i, blk in enumerate(net.blocks):
        yield f"b{i}.conv1", f"blocks.{i}.conv1"
        yield f"b{i}.conv2", f"blocks.{i}.conv2"
        if blk.shortcut is not None:
            yield f"b{i}.shortcut", f"blocks.{i}.shortcut.conv"


def quantize_arcface(net: ArcFace,
                     act_amax: Optional[Dict[str, float]] = None,
                     int8_residual: bool = False) -> ArcFace:
    """Post-training int8 quantization of a float f32 ``net``, the port of
    ``quantize_arcface_params``: every conv site's weight per output
    channel (``layers.quantize_conv_weight``); with ``act_amax`` (per-site
    activation maxima) each site also gets the static activation scale
    ``float32(max(amax, 1e-12) / 127)``, the division taken in Python
    floats and rounded to f32 once, as facekit does (``arcface.py:
    194-204``). ``int8_residual`` (needs ``act_amax``) adds the same scale
    of the block outputs, "stem.out" and "b{i}.out", as ``oscale`` on the
    stem and on each block: the residual form. Returns a new module on
    ``net``'s device in f32; ``net`` is left as it is."""
    if net.int8 is not None or net.compute_dtype != torch.float32:
        raise ValueError("quantize_arcface takes a float f32 ArcFace")
    if int8_residual and act_amax is None:
        raise ValueError("int8_residual requires calibrated act_amax "
                         "(block-output scales have no dynamic mode)")
    state = net.state_dict()
    dev = state["input.conv"].device

    def scale_of(name):
        return torch.tensor(
            np.float32(max(float(act_amax[name]), 1e-12) / 127.0),
            device=dev)

    for name, key in _sites(net):
        q, scale = L.quantize_conv_weight(state.pop(key))
        state[f"{key}.q"] = q
        state[f"{key}.scale"] = scale
        if act_amax is not None:
            state[f"{key}.ascale"] = scale_of(name)
    if int8_residual:
        state["input.oscale"] = scale_of("stem.out")
        for i in range(len(net.blocks)):
            state[f"blocks.{i}.oscale"] = scale_of(f"b{i}.out")
    form = ("residual" if int8_residual else
            "dynamic" if act_amax is None else "static")
    out = ArcFace(net.network, net.input_size, net.embed_dim, int8=form)
    out.load_state_dict(state)
    return out.to(dev).eval()


@torch.inference_mode()
def arcface_act_amax(net: ArcFace, x: torch.Tensor) -> Dict[str, float]:
    """Per-site activation amax of one forward of the float f32 ``net`` on
    (N, H, W, 3) normalized RGB (``arcface.py:311-319``), keyed by the
    names ``quantize_arcface`` reads: "input", "b{i}.conv1", "b{i}.conv2",
    "b{i}.shortcut", and the block outputs "stem.out", "b{i}.out"."""
    if net.int8 is not None or net.compute_dtype != torch.float32:
        raise ValueError("arcface_act_amax runs the float f32 ArcFace")
    stats: Dict[str, torch.Tensor] = {}
    net(x, stats=stats)
    names = list(stats)
    values = torch.stack([stats[n] for n in names]).cpu().tolist()
    return dict(zip(names, values))


def calibrate_arcface_int8(net: ArcFace, batches: Iterable[torch.Tensor],
                           headroom: float = 1.0,
                           int8_residual: bool = False) -> ArcFace:
    """Post-training calibration (``arcface.py:322-347``): fold each site's
    activation maxima over f32 forwards of the float ``net`` on the given
    normalized-RGB batches, then quantize with static activation scales
    from amax * headroom (in Python floats); with ``int8_residual``, into
    the residual form."""
    agg: Dict[str, float] = {}
    n = 0
    for x in batches:
        for k, v in arcface_act_amax(net, x).items():
            agg[k] = max(agg.get(k, 0.0), float(v))
        n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return quantize_arcface(net, {k: v * headroom for k, v in agg.items()},
                            int8_residual=int8_residual)
