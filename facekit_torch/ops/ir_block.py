"""The fused IR residual block: BN -> conv3x3 -> PReLU -> conv3x3 -> BN,
plus the identity shortcut, in one kernel.

The function of facekit's IR block (``facekit/models/arcface.py:99-118``)
for a block with stride 1, no shortcut conv and no SE, with the numerics
of the TPU kernel ``ir_block_fused`` (``docs/experiments/
fused_block_kernel.py:49-115``). For x (N, H, W, C) in bf16 or f32:

  1. (s1, b1), (s2, b2) = ``fused_affine`` of bn1 and bn2, in f32, with
     ``_affine``'s order ``shift = bias - mean * (scale * inv)`` (not
     ``batch_norm``'s ``bias - mean * scale * inv``);
  2. t = dtype(f32(x) * s1 + b1); the conv pads t (not x) with zeros;
  3. m1 = conv3x3(t, w1), f32 accumulation;
  4. u = dtype(m1 > 0 ? m1 : m1 * alpha), alpha f32; zero outside the image;
  5. m2 = conv3x3(u, w2), f32 accumulation;
  6. out = dtype(m2 * s2 + b2 + f32(x)), rounded once.

Weights are (O, 3, 3, C) in x's dtype (K = (kh, kw, c) contiguous per
output channel) and ``par`` is (5, C) f32: s1, b1, alpha, s2, b2.

  * ``ir_block_reference`` is the plain PyTorch version: ``F.conv2d`` in
    f32 on upcast operands, exact for bf16 products; on a CUDA tensor it
    refuses to run with TF32 convolutions on;
  * ``ir_block(x, block)`` is the wrapper ``IRBlock.forward`` calls: CPU
    tensors run the plain version; CUDA tensors launch the hand-written
    Hopper kernel ``ops/csrc/ir_block.cu`` on the current stream, one
    launch per block, or raise. ``ir_block.launches`` counts the launches.
    Neither has a backward (nor has facekit's kernel, and facekit trains
    through the composed block): where the block's output would need a
    gradient (``needs_grad``), ``IRBlock.forward`` runs the composition
    and ``ir_block`` raises, so no autograd graph is cut;
  * ``facekit_torch::ir_block`` is the block as a ``torch.library`` op
    on (x, w1, w2, par): the plain version on the CPU, the kernel on CUDA;
    ``ir_block`` calls it while ``torch.export`` traces;
  * ``u_rounding_bound`` is how far two right versions may lie apart
    through the rounding of u, which the comparisons of the kernel with
    the plain version on the card allow for in bf16;
  * ``bf16_plan`` mirrors how the bf16 kernel cuts a launch into bands
    (its band height, shared memory, cluster and CTAs), so that the CPU
    tests can hold it to the card's limits and the wrapper can refuse a
    shape no band fits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512

# the bf16 kernel's constants (ops/csrc/ir_block.cu)
_TN = 64                  # output channels a CTA
_PASS_TILES = 6           # m64 tiles of a conv pass (2 warpgroups x 3)
_ACC_SETS = 3             # accumulators a warpgroup holds
_MAX_CHAIN = 96           # k16 steps summed into one accumulator
_MAX_BAND_ROWS = 16
_MAX_SMEM = 232448        # 227 KB a CTA
_RING_BYTES = 4 * 8192    # NST stages of 64 channels x 64 of K, bf16
_STAGING = 8 * 16 * 144   # conv2's output rows staged by the 8 consumer warps
H100_SMS = 132


class Bf16Plan(NamedTuple):
    """A bf16 launch: output rows a band, dynamic shared memory (bytes) a
    CTA, CTAs a cluster, m64 tiles of the largest band's conv1 and conv2
    (an image's), CTAs in all, images a CTA."""
    rows: int
    smem: int
    cluster: int
    tiles1: int
    tiles2: int
    ctas: int
    images: int


def _pass_tiles(c):
    """The most m64 tiles a conv pass takes at c channels (``pass_tiles``):
    no accumulator sums more than _MAX_CHAIN of the 9c/16 k16 steps."""
    steps = 9 * c // 16
    t = _PASS_TILES
    while t > 1:
        ks = _ACC_SETS // -(-t // 2)
        if -(-steps // ks) <= _MAX_CHAIN:
            break
        t -= 1
    return t


def _band_rows(r0, r, h):
    """conv1's u rows y1 .. y1e-1 and conv2's output rows r0 .. y2e-1 of
    the band from r0 (``band_rows``)."""
    return max(r0 - 1, 0), min(r0 + r + 1, h), min(r0 + r, h)


def _bf16_layout(r, i, h, w, c):
    """(shared memory, conv1 tiles, conv2 tiles) at band height r with i
    images a CTA, as ``bf16_layout`` lays out the ring and its barriers,
    the band and the u slice (a slab of the same odd number of pixels for
    each chunk of 8 channels and image)."""
    w2 = w + 2
    rows1 = rows2 = 0
    for r0 in range(0, h, r):
        y1, y1e, y2e = _band_rows(r0, r, h)
        rows1, rows2 = max(rows1, y1e - y1), max(rows2, y2e - r0)
    tiles1, tiles2 = -(-rows1 * w2 // 64), -(-rows2 * w2 // 64)
    np_ = ((rows1 + 2) * w2) | 1
    reach1, reach2 = tiles1 * 64 + 2 * w2 + 2, tiles2 * 64 + 2 * w2 + 2
    last = max(np_, reach1, reach2 if c > _TN else 0)
    band = max(16 * ((c // 8 * i - 1) * np_ + last), _STAGING)
    usl = 16 * ((8 * i - 1) * np_ + max(np_, reach2))
    up = lambda b: -(-b // 128) * 128  # noqa: E731
    return _RING_BYTES + 128 + up(band) + up(usl), tiles1, tiles2


@functools.lru_cache(maxsize=None)
def bf16_plan(n: int, h: int, w: int, c: int,
              sms: int = H100_SMS) -> Optional[Bf16Plan]:
    """The bf16 kernel's launch for x (n, h, w, c) on ``sms`` SMs, as its
    ``bf16_plan`` picks the band height: conv2 in one pass (rows * (w+2)
    <= 64 * ``_pass_tiles(c)`` positions), the CTA within 227 KB, and of
    those the fewest rounds of CTAs over the SMs times a CTA's weight
    stages, a stage costed at its pass's tiles but at least 2; two images
    a CTA where each is one tile in both convs and n is even; ties to the
    higher band, then to one image. None where no band fits. Cached: the
    wrapper asks it on every bf16 launch."""
    best = None
    pt = _pass_tiles(c)
    for r in range(1, min(h, _MAX_BAND_ROWS) + 1):
        if r * (w + 2) > pt * 64:
            break
        for i in (2, 1):
            smem, tiles1, tiles2 = _bf16_layout(r, i, h, w, c)
            if smem > _MAX_SMEM or (i == 2 and (n % 2 or tiles1 > 1 or
                                                tiles2 > 1 or pt < 2)):
                continue
            passes = -(-tiles1 // pt)
            per = -(-tiles1 // passes)
            stages = max(tiles2, 2) + sum(max(min(t, per), 2)
                                          for t in range(tiles1, 0, -per))
            ctas = -(-h // r) * (c // _TN) * (n // i)
            cost = -(-ctas // sms) * stages * (9 * c // 64)
            if best is None or cost <= best[0]:
                best = (cost, Bf16Plan(r, smem, c // _TN, tiles1, tiles2, ctas,
                                       i))
    return None if best is None else best[1]


def fused_affine(scale, bias, mean, var, eps: float = BN_EPS):
    """(scale', shift') f32 of an inference BN, in ``_affine``'s order
    (``fused_block_kernel.py:75-80``)."""
    inv = torch.rsqrt(var.float() + eps)
    s = scale.float() * inv
    return s, bias.float() - mean.float() * s


def _sources(block):
    """The block's tensors that the kernel's operands come from."""
    return (block.conv1, block.conv2, block.prelu, block.bn1.scale,
            block.bn1.bias, block.bn1.mean, block.bn1.var, block.bn2.scale,
            block.bn2.bias, block.bn2.mean, block.bn2.var)


def needs_grad(x: torch.Tensor, block) -> bool:
    """Whether the block's output on ``x`` would need a gradient: grad
    mode is on and x or any of the block's tensors requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in _sources(block)))


def block_operands(block, dtype: torch.dtype):
    """(w1, w2, par) of an ``IRBlock`` for the kernel: weights (O, 3, 3, C)
    in ``dtype``, par (5, C) f32. Cached on the block, keyed by the
    identity and version of every tensor they come from, so a block whose
    weights are replaced or edited in place recomputes them."""
    key = (dtype,) + tuple((t.data_ptr(), t._version, t.dtype, t.device)
                           for t in _sources(block))
    cached = getattr(block, "_fused_operands", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    operands = _operands(block, dtype)
    block._fused_operands = (key, operands)
    return operands


def _operands(block, dtype: torch.dtype):
    """``block_operands`` computed afresh, from the block's tensors as they
    are: inside a ``torch.export`` trace these are the state passed in, so
    the graph computes the operands and the block's cache is not read."""
    with torch.no_grad():
        w1 = block.conv1.to(dtype).permute(0, 2, 3, 1).contiguous()
        w2 = block.conv2.to(dtype).permute(0, 2, 3, 1).contiguous()
        s1, b1 = fused_affine(block.bn1.scale, block.bn1.bias,
                              block.bn1.mean, block.bn1.var)
        s2, b2 = fused_affine(block.bn2.scale, block.bn2.bias,
                              block.bn2.mean, block.bn2.var)
        par = torch.stack([s1, b1, block.prelu.float(), s2, b2]).contiguous()
    return w1, w2, par


def ir_block_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       par: torch.Tensor) -> torch.Tensor:
    """The plain version; see the module docstring for its meaning."""
    if x.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("ir_block_reference: set torch.backends.cudnn."
                           "allow_tf32 = False, or the f32 convs run in TF32")
    _, _, _, s2, b2 = par.float()
    m2 = _conv3x3(_plain_u(x, w1, par).float(), w2.float())
    return (m2 * s2 + b2 + x.float()).to(x.dtype)


def _conv3x3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC a, (O, 3, 3, C) w -> NHWC stride-1, zero-padded conv."""
    return F.conv2d(a.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                    padding=1).permute(0, 2, 3, 1)


def _plain_u(x, w1, par) -> torch.Tensor:
    """Steps 2-4: u in x's dtype."""
    s1, b1, alpha = par[:3].float()
    t = (x.float() * s1 + b1).to(x.dtype)
    m1 = _conv3x3(t.float(), w1.float())
    return torch.where(m1 > 0, m1, m1 * alpha).to(x.dtype)


def u_rounding_bound(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     par: torch.Tensor) -> torch.Tensor:
    """Per output element, how far two right versions of the block may lie
    apart through the rounding of u alone: each rounds u to x's dtype from
    f32 sums taken in its own order, so an element of u may land one step
    (ulp) of that dtype away, and each such step moves m2 by |w2| times
    it. Returns |s2| * conv3x3(ulp(u), |w2|) in f32, with u from the plain
    version. Far above what two versions show (a step of u is taken only
    where m1 lies within an f32 rounding of a midpoint), so a test holds
    most elements to the output's own rounding and all to this."""
    u = _plain_u(x, w1, par).float()
    # |u| in [2**(e-1), 2**e) has a step of 2**(e-1) * eps
    exp = torch.frexp(u)[1].float()
    ulp = torch.where(u == 0, 0.0,
                      torch.exp2(exp - 1) * torch.finfo(x.dtype).eps)
    return par[3].float().abs() * _conv3x3(ulp, w2.float().abs())


def ir_block(x: torch.Tensor, block) -> torch.Tensor:
    """One stride-1, identity-shortcut, SE-free float ``IRBlock`` applied
    to x (N, H, W, C). CPU tensors run ``ir_block_reference``; CUDA tensors
    launch the kernel on the current stream, without synchronizing, or
    raise. Under ``torch.export`` the operands are computed in the graph
    and the block is the registered op ``facekit_torch::ir_block``, which
    runs the same two functions. Raises where the output would need a
    gradient (``needs_grad``): neither version has a backward."""
    if needs_grad(x, block):
        raise RuntimeError(
            "ir_block: grad mode is on and x or the block's tensors require "
            "grad, but the fused block has no backward; run IRBlock.composed "
            "(IRBlock.forward does), or call under torch.no_grad() or "
            "torch.inference_mode()")
    if torch.compiler.is_exporting():
        return torch.ops.facekit_torch.ir_block(x, *_operands(block, x.dtype))
    w1, w2, par = block_operands(block, x.dtype)
    if x.device.type == "cpu":
        return ir_block_reference(x, w1, w2, par)
    return _ir_block_cuda(x, w1, w2, par)


ir_block.launches = 0


@functools.cache
def _library():
    """The kernel's C entry point, built at first use."""
    from facekit_torch.ops import _build
    fn = _build.load("ir_block").facekit_ir_block
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w1, w2, par):
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (w1, w2, par)):
        raise ValueError(f"ir_block: x on {x.device}, weights on "
                         f"{w1.device}/{w2.device}, par on {par.device}; all "
                         "must be on one CUDA device (or x on the CPU)")
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"ir_block: x {x.dtype}, w1 {w1.dtype}, w2 "
                        f"{w2.dtype}; the kernel takes bf16 or f32, all one "
                        "dtype")
    if x.dim() != 4:
        raise ValueError(f"ir_block: x {tuple(x.shape)}, (N, H, W, C) "
                         "expected")
    c = x.shape[3]
    if w1.shape != (c, 3, 3, c) or w2.shape != (c, 3, 3, c) or \
            par.shape != (5, c) or par.dtype != torch.float32:
        raise ValueError(f"ir_block: w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, par {tuple(par.shape)} "
                         f"{par.dtype}; ({c}, 3, 3, {c}) weights and (5, {c})"
                         " f32 expected")
    if c % 64 or c > _MAX_C:
        raise ValueError(f"ir_block: {c} channels; the kernel takes a "
                         f"multiple of 64 up to {_MAX_C}")


def _ir_block_cuda(x, w1, w2, par):
    _check(x, w1, w2, par)
    x, w1, w2, par = (t.contiguous() for t in (x, w1, w2, par))
    n, h, w, c = x.shape
    if x.numel() >= 2 ** 31:
        raise ValueError("ir_block: tensors of 2**31 elements or more")
    if x.dtype == torch.bfloat16 and bf16_plan(n, h, w, c) is None:
        raise ValueError(f"ir_block: no bf16 band fits {w} columns of {c} "
                         "channels: a band of one row takes W + 2 <= 384 "
                         "positions (128 from 256 channels on) and at most "
                         "227 KB of shared memory")
    if any(t.data_ptr() % 16 for t in (x, w1, w2, par)):
        raise ValueError("ir_block: x, weights and par must be 16-byte "
                         "aligned")
    out = torch.empty_like(x)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), par.data_ptr(),
                 out.data_ptr(), n, h, w, c, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ir_block: kernel launch failed with CUDA error "
                           f"{err}")
    ir_block.launches += 1
    return out


# -- the block as a registered op, for torch.export

@torch.library.custom_op("facekit_torch::ir_block", mutates_args=(),
                         device_types="cpu")
def _ir_block_op(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 par: torch.Tensor) -> torch.Tensor:
    return ir_block_reference(x, w1, w2, par)


_ir_block_op.register_kernel("cuda")(_ir_block_cuda)


@_ir_block_op.register_fake
def _(x, w1, w2, par):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
