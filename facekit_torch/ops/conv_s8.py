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
(``conv_route``): a dense conv of 16 input channels or more (every IR-50
site but the stem, and most detector sites) runs an implicit GEMM on s8
``wgmma`` warpgroup tensor cores fed by TMA, in CTA tiles and K splits
that ``_conv_plan`` chooses, reading x through the im2col box that
``_im2col_box`` computes; the two others run on CUDA cores in bands of
whole output rows that ``_band_plan`` chooses: a dense conv of at most 8
input channels (the stems' 3, read as they are, and 8-channel inputs) on
``__dp4a``, and a depthwise conv (``groups`` = C: the detectors' 3x3 dw
sites). Both dense routes take any multiple of 8 output channels. The
plan passed to the C entry point names the dense route (``bn = 0``:
dp4a); ``groups`` names the depthwise one.

The convolution is also the ``torch.library`` op ``facekit_torch::conv_s8``
(the plain version on the CPU, the kernel on CUDA), which the wrapper
calls while ``torch.export`` traces it.

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
CONV_BM = 128          # output pixels per tile of the tensor-core route
CONV_BK = 128          # bytes of K per pipeline stage of that route
# the output channels a tile of that route takes: the s8 wgmma widths the
# kernel is built for (m64nNk32 takes N = 8, 16, 24, 32, 48, 64, ...)
MMA_TILES = (8, 16, 24, 32, 48, 64, 96, 128)
# the least stages of K a split takes: one 128 x 128 stage reads 32 KiB of
# operands, and each split adds a 64 KiB tile of int32 to the reduction
MIN_SPLIT_STAGES = 2
# the most splits of K: the splits of a tile run as one thread-block
# cluster, whose portable size is 8 CTAs
MAX_SPLITS = 8
# a tensor-core CTA's shared memory (TcConv in ops/csrc/conv_s8.cu): at
# most TC_SMEM, of which TC_SMEM_SPARE goes to alignment and barriers; with
# resident weights, at least TC_MIN_RING stages of pixels beside them
TC_SMEM = 232448
TC_SMEM_SPARE = 2048
TC_MIN_RING = 4
# |sum| <= 128**2 * K must stay below 2**31 (int8 spans -128..127)
MAX_K = (2 ** 31 - 1) // 128 ** 2
# the band routes (CUDA cores): the most input channels of the dense one,
# its output-channel tiles (an exact tile for these O, else 64), the
# threads of a CTA, the CTAs an SM holds (the kernels' launch bounds), the
# dynamic shared memory a CTA may take so that they fit in an SM's 228 KiB
# with the 1 KiB the system keeps for each, the most rows a band takes (so
# that a large map still gives each CTA several bands to overlap), and the
# input buffers of a CTA (a band and 3 ahead)
DP4A_MAX_C = 8
DENSE_TILES = (8, 16, 32, 64)
BAND_THREADS = 256
BAND_CTAS_PER_SM = 2
BAND_SMEM = 112 * 1024
BAND_MAX_ROWS = 8
BAND_RING = 4
DW_MIN_CH = 8          # the fewest channels a depthwise band takes (or C)


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
    raises. ``conv_s8.launches`` counts the launches, and
    ``conv_s8.route_launches`` those of each route. Under
    ``torch.export`` it is the registered op ``facekit_torch::conv_s8``,
    which runs the same two functions.
    """
    if torch.compiler.is_exporting():
        return torch.ops.facekit_torch.conv_s8(x, w, int(stride),
                                               int(padding), int(groups))
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_s8_reference(x, w, stride, padding, groups)
    return _conv_s8_cuda(x, w, int(stride), int(padding), int(groups))


conv_s8.launches = 0
conv_s8.route_launches = dict.fromkeys(("mma", "dp4a", "dw"), 0)


def conv_route(c: int, groups: int = 1) -> str:
    """The kernel a CUDA tensor of ``c`` input channels runs: ``"dw"``
    (CUDA cores, 9 taps a channel) where ``groups`` > 1 (= C, depthwise),
    else ``"mma"`` (s8 ``wgmma`` warpgroup tensor cores fed by TMA) from
    MMA_MIN_C channels on, else ``"dp4a"`` (CUDA cores; at most DP4A_MAX_C
    channels: the stems' 3 and 8-channel inputs; 9 to 15 are refused)."""
    if groups > 1:
        return "dw"
    return "mma" if c >= MMA_MIN_C else "dp4a"


class ConvPlan(NamedTuple):
    """The launch the kernel takes. ``bn = 0`` (``_NO_PLAN``): the dp4a
    or (``groups`` > 1) the depthwise route. Else the tensor-core route:
    tiles of ``CONV_BM`` pixels x ``bn`` output channels, ``m_tiles`` x
    ``n_tiles`` of them, over the ``stages`` stages of K, split into
    ``splits`` clusters' shares (split y takes stages stages*y/splits ..
    stages*(y+1)/splits - 1, at most ``per_split``); a grid of (``ctas``,
    ``splits``) CTAs: with splits one a tile, else ``ctas`` persistent
    CTAs that walk the tiles; ``resident``: each CTA loads the weights
    once and keeps them in shared memory."""
    bn: int
    m_tiles: int
    n_tiles: int
    stages: int
    splits: int
    per_split: int
    ctas: int
    resident: bool


_NO_PLAN = ConvPlan(0, 0, 0, 0, 1, 0, 0, False)  # the CUDA-core routes take none


def _tile_n(o: int) -> int:
    """The output channels of a tensor-core tile: ``o`` split into as few
    tiles of at most MMA_TILES[-1] as hold it, each the least width of
    MMA_TILES that holds its share (past ``o`` the weights are zeros and
    the stores skipped)."""
    n_tiles = -(-o // MMA_TILES[-1])
    share = -(-o // n_tiles)
    return next(t for t in MMA_TILES if t >= share)


def _cluster_ctas(size: int, sms: int) -> int:
    """The CTAs that clusters of ``size`` CTAs, one CTA an SM, hold at
    once on ``sms`` SMs. A cluster lies in one GPC, and GPCs leave SMs
    over: on an H100 SXM's 132, cudaOccupancyMaxActiveClusters gives 66
    clusters of 2, 30 of 4 and 15 of 8 tensor-core CTAs (120 of the SMs
    from 4 on), which this scales to ``sms``."""
    if size <= 2:
        return sms // size * size
    return sms * 10 // 11 // size * size


@functools.lru_cache(maxsize=1024)     # a model has a few dozen shapes
def _conv_plan(n: int, oh: int, ow: int, o: int, k: int, sms: int
               ) -> ConvPlan:
    """The tile, K split and clusters of the tensor-core route for an
    output of ``n * oh * ow`` pixels x ``o`` channels over ``k`` bytes of
    K (KS*KS*C) on a card of ``sms`` SMs.

    Tiles are CONV_BM x ``_tile_n(o)``. Where they fill fewer CTAs than
    the card has SMs (small batches, the 7x7 and 14x14 stages), K splits
    across the CTAs of a cluster in whole stages: the most splits of 8, 4
    and 2 whose clusters all run at once (``_cluster_ctas``) and whose
    splits each take at least MIN_SPLIT_STAGES stages (so a 1x1 site of
    one or two stages never splits); the splits of a tile sum their
    partial tiles in distributed shared memory, exact in int32. Unsplit,
    one persistent CTA an SM walks the tiles; where O is one tile and its
    weights leave room for TC_MIN_RING stages of pixels, each CTA loads
    them once and keeps them (the large maps' CTAs would else read them
    from L2 again for every tile)."""
    bn = _tile_n(o)
    m_tiles = -(-(n * oh * ow) // CONV_BM)
    n_tiles = -(-o // bn)
    stages = -(-k // CONV_BK)
    tiles = m_tiles * n_tiles
    splits = 1
    if tiles < sms:
        splits = next((s for s in (MAX_SPLITS, MAX_SPLITS // 2, 2)
                       if s * MIN_SPLIT_STAGES <= stages
                       and tiles * s <= _cluster_ctas(s, sms)), 1)
    if splits > 1:
        return ConvPlan(bn, m_tiles, n_tiles, stages, splits,
                        -(-stages // splits), tiles, False)
    resident = (n_tiles == 1 and stages * bn * CONV_BK
                <= TC_SMEM - TC_SMEM_SPARE - TC_MIN_RING * CONV_BM * CONV_BK)
    return ConvPlan(bn, m_tiles, n_tiles, stages, 1, stages,
                    min(tiles, sms), resident)


class Im2colBox(NamedTuple):
    """How the tensor-core route reads x (N, H, W, C): im2col loads of a
    tensor map whose bounding box holds the first (top-left) tap of every
    output pixel, from ``lower`` (w, h) to (W - 1, H - 1) + ``upper``,
    traversed at ``stride`` in both; a load brings ``pixels`` pixels (a
    tile's, in output order across rows and images, zeros past the last
    image) of ``channels`` bytes of one tap, the tap added as the load's
    offset (zeros off the image); ``loads`` loads fill a stage of CONV_BK
    bytes of K."""
    lower: tuple
    upper: tuple
    stride: int
    pixels: int
    channels: int
    loads: int


@functools.lru_cache(maxsize=1024)
def _im2col_box(c: int, ks: int, stride: int, pad: int) -> Im2colBox:
    """The im2col box of a ``ks`` x ``ks`` conv of ``c`` input channels
    (a power of two >= MMA_MIN_C) at ``stride`` and ``pad``: the first
    taps run from -pad to W + pad - ks, so the upper corner is pad -
    (ks - 1); a load takes a tile's CONV_BM pixels, min(c, CONV_BK)
    channels of a tap each."""
    channels = min(c, CONV_BK)
    return Im2colBox((-pad, -pad), (pad - (ks - 1), pad - (ks - 1)), stride,
                     CONV_BM, channels, CONV_BK // channels)


@functools.lru_cache(maxsize=1024)
def _box_arg(c: int, ks: int, stride: int, pad: int):
    """``_im2col_box`` as the 7 ints the C entry point takes: lower w, h,
    upper w, h, traversal stride, pixels, channels."""
    b = _im2col_box(c, ks, stride, pad)
    return (ctypes.c_int * 7)(*b.lower, *b.upper, b.stride, b.pixels,
                              b.channels)


def _launch_plan(n: int, oh: int, ow: int, o: int, c: int, ks: int,
                 sms: int, groups: int = 1) -> ConvPlan:
    """The plan the C entry point takes for ``c`` input channels (at most
    DP4A_MAX_C, or a power of two >= 16, where ``groups`` is 1) and a
    ``ks`` x ``ks`` kernel: ``_NO_PLAN`` on the dp4a and depthwise routes
    (which take ``_band_plan``), else ``_conv_plan``."""
    if conv_route(c, groups) != "mma":
        return _NO_PLAN
    return _conv_plan(n, oh, ow, o, ks * ks * c, sms)


class BandPlan(NamedTuple):
    """The launch of a band route (dp4a or depthwise): bands of ``rows``
    output rows of one image (the last of an image may take fewer) and
    ``ch`` output channels, ``chunks`` = ceil(O / ch) tiles of channels
    (gridDim.y) by ``bands`` = N * ceil(OH / rows) bands each, walked by
    ``ctas`` persistent CTAs (gridDim.x) of ``smem`` bytes of dynamic
    shared memory."""
    rows: int
    ch: int
    chunks: int
    bands: int
    ctas: int
    smem: int



def _align16(v: int) -> int:
    return -(-v // 16) * 16


def _band_smem(w: int, c: int, ks: int, stride: int, rows: int, ch: int,
               groups: int = 1) -> int:
    """Dynamic shared memory (bytes) of a band CTA, as the kernel lays it
    out (``DenseBand`` and ``DwBand`` in ops/csrc/conv_s8.cu). Dense: the
    tile's weights (as they lie in w, each run copied from the 16-byte
    word at or below its first byte, then as 4-channel words), BAND_RING
    raw buffers of a band's input rows and their tile of 4-channel words
    with a zero column either side. Depthwise: the weights and BAND_RING
    byte tiles. The sums go out from registers."""
    ir = (rows - 1) * stride + ks
    if groups > 1:
        return (_align16(ch * 9 + 15)
                + BAND_RING * _align16(ir * (w + 2) * ch))
    cw = -(-c // 4)
    return (_align16(ch * ks * ks * c + 15) + ch * ks * ks * cw * 4
            + BAND_RING * _align16(ir * w * c + 15)
            + _align16(ir * (w + 2) * cw * 4))


@functools.lru_cache(maxsize=1024)     # a model has a few dozen shapes
def _band_plan(n: int, h: int, w: int, c: int, o: int, ks: int, stride: int,
               pad: int, groups: int, sms: int) -> BandPlan:
    """The bands of a dp4a (``c`` <= DP4A_MAX_C) or depthwise (``groups``
    = C) conv on a card of ``sms`` SMs.

    The channel tile: dense, O itself where O is in DENSE_TILES, else 64;
    depthwise, the most of C, C/2, C/4, ... (multiples of 4, at least
    DW_MIN_CH or C) whose bands of one row fit in BAND_SMEM and still give
    every SM one, else the fewest that fit. A shape whose band of one row
    does not fit (at the least tile) raises.
    Then the rows a band: the fewest with which the bands number no more
    than the CTAs the card holds (BAND_CTAS_PER_SM an SM), so that they
    all run at once and none waits for a second round, up to BAND_MAX_ROWS
    and as far as BAND_SMEM allows. The CTAs: one for each band, at most
    BAND_CTAS_PER_SM an SM."""
    oh = (h + 2 * pad - ks) // stride + 1
    slots = BAND_CTAS_PER_SM * sms

    def smem(rows, ch):
        return _band_smem(w, c, ks, stride, rows, ch, groups)
    if groups > 1:
        tiles = [c]
        while tiles[-1] % 8 == 0 and tiles[-1] // 2 >= min(c, DW_MIN_CH):
            tiles.append(tiles[-1] // 2)
        tiles = [t for t in tiles if t <= 4 * BAND_THREADS
                 and smem(1, t) <= BAND_SMEM]
        ch = next((t for t in tiles if n * oh * (c // t) >= sms),
                  tiles[-1] if tiles else 0)
    else:
        ch = o if o in DENSE_TILES else DENSE_TILES[-1]
        if smem(1, ch) > BAND_SMEM:
            ch = 0
    if not ch:
        raise ValueError(f"conv_s8: a band of one output row of a {w}-pixel "
                         f"wide input (C = {c}, O = {o}) does not fit in "
                         f"{BAND_SMEM} bytes of shared memory")
    chunks = -(-o // ch)
    rows = 1
    while (rows < min(oh, BAND_MAX_ROWS) and n * -(-oh // rows) * chunks
           > slots and smem(rows + 1, ch) <= BAND_SMEM):
        rows += 1
    bands = n * -(-oh // rows)
    return BandPlan(rows, ch, chunks, bands,
                    min(bands, max(1, slots // chunks)), smem(rows, ch))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library():
    """The kernel's library, built at first use: the conv's C entry point
    (``facekit_conv_s8``), the shared memory of a band CTA
    (``facekit_conv_s8_band_smem``, held to ``_band_smem`` by the tests on
    the card), the clusters of tensor-core CTAs the card runs at once
    (``facekit_conv_s8_max_clusters``, held to ``_cluster_ctas`` there)
    and an empty launch (``facekit_launch_floor``)."""
    from facekit_torch.ops import _build
    lib = _build.load("conv_s8")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("facekit_conv_s8", [p, p, p] + [i] * 17 + [p, p]),
                       ("facekit_conv_s8_band_smem", [i] * 7),
                       ("facekit_conv_s8_max_clusters", [i]),
                       ("facekit_launch_floor", [p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def max_clusters(size: int) -> int:
    """The clusters of ``size`` tensor-core CTAs (K split along y) that the
    current CUDA device runs at once (cudaOccupancyMaxActiveClusters)."""
    n = _library().facekit_conv_s8_max_clusters(size)
    if n < 0:
        raise RuntimeError(f"max_clusters: CUDA error {-n}")
    return n


def launch_floor() -> None:
    """Launches one empty kernel of one CTA on the current stream, through
    ctypes as the conv is: what a launch costs the card with no work."""
    err = _library().facekit_launch_floor(
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_floor: CUDA error {err}")


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


def _plan_args(plan, n, h, wd, c, o, ks, stride, pad, groups, sms):
    """The C entry point's plan arguments under ``plan``: bn, splits,
    resident, rows, ch, ctas and the im2col box (``_box_arg``; None on the
    band routes, whose rows, ch and ctas ``_band_plan`` gives)."""
    if plan.bn:
        return (plan.bn, plan.splits, int(plan.resident), 0, 0, plan.ctas,
                _box_arg(c, ks, stride, pad))
    band = _band_plan(n, h, wd, c, o, ks, stride, pad, groups, sms)
    return (0, 1, 0, band.rows, band.ch, band.ctas, None)


@functools.lru_cache(maxsize=1024)     # a model has a few dozen shapes
def _call_args(n, h, wd, c, o, ks, stride, pad, groups, sms):
    """``_plan_args`` of ``_launch_plan``'s plan: what a call of this
    shape passes, looked up once."""
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (wd + 2 * pad - ks) // stride + 1
    return _plan_args(_launch_plan(n, oh, ow, o, c, ks, sms, groups), n, h,
                      wd, c, o, ks, stride, pad, groups, sms)


def _conv_s8_cuda(x, w, stride, padding, groups=1, plan=None):
    """The kernel's launch on CUDA tensors, with ``_launch_plan``'s plan
    or (a test's) ``plan``."""
    _check(x, w, stride, padding, groups)
    c = x.shape[3]
    if groups == 1 and c > DP4A_MAX_C and (c < MMA_MIN_C or c & (c - 1)):
        raise ValueError(f"conv_s8: {c} input channels; the dense routes "
                         f"take at most {DP4A_MAX_C} or a power of two >= "
                         f"{MMA_MIN_C}")
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
    sms = _sms(x.device.index)
    args = (_call_args(n, h, wd, c, o, ks, stride, padding, groups, sms)
            if plan is None else _plan_args(plan, n, h, wd, c, o, ks, stride,
                                            padding, groups, sms))
    out = torch.empty((n, oh, ow, o), dtype=torch.int32, device=x.device)
    fn = _library().facekit_conv_s8
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, o,
                 ks, stride, padding, oh, ow, groups, *args, stream)
    if err != 0:
        raise RuntimeError(f"conv_s8: kernel launch failed with CUDA error "
                           f"{err}")
    conv_s8.launches += 1
    conv_s8.route_launches[conv_route(c, groups)] += 1
    return out


# -- the convolution as a registered op, for torch.export

@torch.library.custom_op("facekit_torch::conv_s8", mutates_args=(),
                         device_types="cpu")
def _conv_s8_op(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
                groups: int) -> torch.Tensor:
    return conv_s8_reference(x, w, stride, padding, groups)


_conv_s8_op.register_kernel("cuda")(_conv_s8_cuda)


@_conv_s8_op.register_fake
def _(x, w, stride, padding, groups):
    n, h, wd, _ = x.shape
    o, ks = w.shape[0], w.shape[1]
    return x.new_empty((n, (h + 2 * padding - ks) // stride + 1,
                        (wd + 2 * padding - ks) // stride + 1, o),
                       dtype=torch.int32)
