"""s8 x s8 -> s32 convolution: every conv site of the int8 embedder and
of the int8 detectors.

Two functions with one meaning, on NHWC int8 input and (O, KH, KW, C /
groups) int8 weights (K runs along C), symmetric zero padding, int32 NHWC
output, the exact integer sum; ``groups`` is 1 or C (depthwise):

  * ``conv_s8_reference`` — the plain PyTorch version: a float64
    ``F.conv2d``, exact because every |sum| <= 127**2 * KH*KW*C < 2**53;
    zero padding of the quantized input is what facekit's
    ``conv_general_dilated`` padding of ``xq`` gives;
  * ``conv_s8`` — the wrapper: for CUDA tensors it launches the
    hand-written Hopper kernel ``ops/csrc/conv_s8.cu`` (the port of the TPU
    kernel ``conv_s8_s2_pallas``, ``docs/experiments/
    pallas_s8_stride2_conv.py:86``, made general) or raises; for CPU
    tensors it runs the plain version.

The kernel has three routes, and the wrapper alone chooses
(``conv_route``): a depthwise conv (``groups`` = C: the detectors' 3x3
dw sites) runs a CUDA-core kernel that sums each output's 9 taps; a dense
conv of 16 input channels or more (every IR-50 site but the stem, and
most detector sites) runs an implicit GEMM on s8 ``mma.sync`` tensor
cores, in CTA tiles and K splits that ``_conv_plan`` chooses; the stems'
3 channels (padded to 4) and 8-channel inputs run a ``__dp4a`` kernel on
CUDA cores. Both dense routes take any multiple of 8 output channels.
The plan passed to the C entry point names the dense route (``bn = 0``:
dp4a); ``groups`` names the depthwise one.

PyTorch has no s8 convolution on CUDA, so no float path stands in for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

O_MULTIPLE = 8         # output channels must come in multiples of this
MMA_MIN_C = 16         # input channels from which the tensor-core route runs
CONV_BM = 128          # output pixels per CTA of the tensor-core route
CONV_BK = 128          # bytes of K per pipeline stage of that route
# the least stages of K a split takes: one 128 x 128 stage reads 32 KiB of
# operands, and each split adds a 64 KiB tile of int32 to the reduction
MIN_SPLIT_STAGES = 2
# the most splits of K: the splits of a tile run as one thread-block
# cluster, whose portable size is 8 CTAs
MAX_SPLITS = 8
# |sum| <= 128**2 * K must stay below 2**31 (int8 spans -128..127)
MAX_K = (2 ** 31 - 1) // 128 ** 2


def conv_s8_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      padding: int = 0, groups: int = 1) -> torch.Tensor:
    """x (N, H, W, C) int8, w (O, KH, KW, C / groups) int8 -> (N, OH, OW,
    O) int32."""
    out = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   w.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=padding, groups=groups)
    return out.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_s8(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding: int = 0, groups: int = 1) -> torch.Tensor:
    """The s8 convolution; see the module docstring for its meaning.

    CPU tensors run ``conv_s8_reference``. CUDA tensors launch the kernel
    on the current stream, without synchronizing; a shape it does not take
    raises. ``conv_s8.launches`` counts the launches.
    """
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_s8_reference(x, w, stride, padding, groups)
    return _conv_s8_cuda(x, w, int(stride), int(padding), int(groups))


conv_s8.launches = 0


def conv_route(c: int, groups: int = 1) -> str:
    """The kernel a CUDA tensor of ``c`` input channels runs: ``"dw"``
    (CUDA cores, 9 taps a channel) where ``groups`` > 1 (= C, depthwise),
    else ``"mma"`` (s8 ``mma.sync`` tensor cores) from MMA_MIN_C channels
    on, else ``"dp4a"`` (CUDA cores; the stems' 3 channels, padded to 4,
    and 8-channel inputs)."""
    if groups > 1:
        return "dw"
    return "mma" if c >= MMA_MIN_C else "dp4a"


class ConvPlan(NamedTuple):
    """The launch the kernel takes. ``bn = 0`` (``_NO_PLAN``): the dp4a
    or (``groups`` > 1) the depthwise route. Else the tensor-core route: a grid of (n_tiles * m_tiles, splits)
    CTAs, each ``CONV_BM`` pixels x ``bn`` output channels over
    ``per_split`` of the ``stages`` stages of K (the last split may take
    fewer); the splits of a tile are one cluster."""
    bn: int
    m_tiles: int
    n_tiles: int
    stages: int
    splits: int
    per_split: int


_NO_PLAN = ConvPlan(0, 0, 0, 0, 1, 0)    # the CUDA-core routes take none


@functools.lru_cache(maxsize=1024)     # a model has a few dozen shapes
def _conv_plan(n: int, oh: int, ow: int, o: int, k: int, sms: int
               ) -> ConvPlan:
    """The tile and K split of the tensor-core route for an output of
    ``n * oh * ow`` pixels x ``o`` channels over ``k`` bytes of K
    (KS*KS*C) on a card of ``sms`` SMs.

    Tiles are CONV_BM x 128 where ``o`` is a multiple of 128, else
    CONV_BM x 64; the last 64-channel tile of an ``o`` that is no multiple
    of 64 (the detectors' 8, 16 and 32) is partly past ``o``, its weight
    rows zero-filled and its stores skipped. Where the tiles fill fewer CTAs than the card has SMs
    (small batches, the 7x7 and 14x14 stages), K splits across CTAs in
    whole stages: as many splits as make a CTA per SM, at most MAX_SPLITS,
    of at least MIN_SPLIT_STAGES stages each but the last (so a 1x1 site of
    one or two stages never splits), the stages shared as evenly as whole
    stages allow. The splits of a tile form one cluster and sum their
    partial tiles in distributed shared memory; int32 sums are exact in any
    order."""
    bn = 128 if o % 128 == 0 else 64
    m_tiles = -(-(n * oh * ow) // CONV_BM)
    n_tiles = -(-o // bn)
    stages = -(-k // CONV_BK)
    tiles = m_tiles * n_tiles
    splits = 1 if tiles >= sms else min(MAX_SPLITS, -(-stages // max(
        MIN_SPLIT_STAGES, stages * tiles // sms)))
    per = -(-stages // splits)
    return ConvPlan(bn, m_tiles, n_tiles, stages, -(-stages // per), per)


def _launch_plan(n: int, oh: int, ow: int, o: int, c: int, ks: int,
                 sms: int, groups: int = 1) -> ConvPlan:
    """The plan the C entry point takes for ``c`` input channels (a power
    of two >= 4 where ``groups`` is 1) and a ``ks`` x ``ks`` kernel:
    ``_NO_PLAN`` on the dp4a and depthwise routes, else ``_conv_plan``."""
    if conv_route(c, groups) != "mma":
        return _NO_PLAN
    return _conv_plan(n, oh, ow, o, ks * ks * c, sms)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library():
    """The kernel's C entry point, built at first use."""
    from facekit_torch.ops import _build
    fn = _build.load("conv_s8").facekit_conv_s8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
           groups: int):
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv_s8: x on {x.device} and w on {w.device}; "
                         "both must be on one CUDA device (or both on the "
                         "CPU)")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv_s8: x {x.dtype}, w {w.dtype}; the kernel "
                        "takes int8")
    if x.dim() != 4 or w.dim() != 4 or groups < 1 or \
            x.shape[3] != w.shape[3] * groups:
        raise ValueError(f"conv_s8: x {tuple(x.shape)} (N, H, W, C) and w "
                         f"{tuple(w.shape)} (O, KH, KW, C / groups) with "
                         f"groups {groups} expected")
    o, kh, kw, _ = w.shape
    c = x.shape[3]
    if kh != kw or kh not in (1, 3):
        raise ValueError(f"conv_s8: kernel {kh}x{kw}; the kernel takes 1x1 "
                         "or 3x3")
    if stride not in (1, 2) or padding not in (0, 1):
        raise ValueError(f"conv_s8: stride {stride}, padding {padding}; the "
                         "kernel takes stride 1 or 2 and padding 0 or 1")
    if groups > 1 and (groups != c or o != c or kh != 3 or c % 4):
        raise ValueError(f"conv_s8: groups {groups} with C = {c}, O = {o}, "
                         f"{kh}x{kw}; the kernel takes groups 1, or "
                         "depthwise 3x3 (groups = C = O) with C a multiple "
                         "of 4")
    if o % O_MULTIPLE:
        raise ValueError(f"conv_s8: {o} output channels; the kernel takes a "
                         f"multiple of {O_MULTIPLE}")


def _conv_s8_cuda(x, w, stride, padding, groups=1):
    _check(x, w, stride, padding, groups)
    c = x.shape[3]
    if c % 4:
        # the stem's 3 channels: zero channels add nothing to the sum
        x = F.pad(x, (0, 4 - c % 4))
        w = F.pad(w, (0, 4 - c % 4))
        c = x.shape[3]
    if groups == 1 and c & (c - 1):
        raise ValueError(f"conv_s8: {c} input channels; the dense routes "
                         "take a power of two")
    x, w = x.contiguous(), w.contiguous()
    n, h, wd, _ = x.shape
    o, ks = w.shape[0], w.shape[1]
    k = ks * ks * w.shape[3]
    if k > MAX_K:
        raise ValueError(f"conv_s8: K = {k} could overflow the "
                         f"int32 sums; the kernel takes K <= {MAX_K}")
    oh = (h + 2 * padding - ks) // stride + 1
    ow = (wd + 2 * padding - ks) // stride + 1
    if n * h * wd * c >= 2 ** 31 or n * oh * ow * o >= 2 ** 31:
        raise ValueError("conv_s8: tensors of 2**31 elements or more")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv_s8: x and w must be 16-byte aligned")
    plan = _launch_plan(n, oh, ow, o, c, ks, _sms(x.device.index), groups)
    out = torch.empty((n, oh, ow, o), dtype=torch.int32, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, o,
                 ks, stride, padding, oh, ow, groups, plan.bn, plan.splits,
                 plan.per_split, stream)
    if err != 0:
        raise RuntimeError(f"conv_s8: kernel launch failed with CUDA error "
                           f"{err}")
    conv_s8.launches += 1
    return out
