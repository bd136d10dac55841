"""Cosine-similarity gallery search: f32 scores fused with top-k.

Port of ``facekit/ops/similarity.py``. Two searches, each a plain version
and a wrapper:

  * ``cosine_topk_reference`` — the plain PyTorch version of
    ``cosine_topk_xla`` (``similarity.py:42-56``); ``cosine_topk`` — its
    wrapper: for CUDA tensors it launches the hand-written Hopper kernel
    ``ops/csrc/cosine_topk.cu`` (the port of the TPU kernel
    ``cosine_topk_pallas``) or raises; for CPU tensors it runs the plain
    version;
  * ``cosine_topk_int8_reference`` — the plain version of
    ``cosine_topk_int8`` (``similarity.py:73-94``) over an int8 gallery
    with per-row scales (``quantize_rows_int8``); ``cosine_topk_int8`` —
    its wrapper, launching ``ops/csrc/cosine_topk_int8.cu`` (the port of
    ``cosine_topk_int8_pallas``) for CUDA tensors.

Batches above 8 of every search run one tensor-core pass 1,
``topk_partial_mma_kernel`` in ``ops/csrc/topk_mma.cuh``, shared by both
kernels: ``mma.sync`` in bf16 or s8, and in f32 three TF32 passes
(3xTF32, which keeps f32's digits where one TF32 pass would not);
batches up to 8 run each kernel's CUDA-core pass 1. ``_mma_queries`` is
that rule. At k > 1 the CUDA-core pass 1 buffers the scores that pass its
thresholds and merges them into its lists 32 at a time, over chunks twice
as long as at k = 1 (``_search_plan``), and the one pass 2 of every search
keeps only the partials at or above a lower bound on each query's k-th
score (``ops/csrc/topk_fold.cuh``).

Each search is also the ``torch.library`` op ``facekit_torch::cosine_topk``
/ ``facekit_torch::cosine_topk_int8`` (its plain version on the CPU, its
kernel on CUDA), which the wrappers call while ``torch.export`` traces
them; eager calls go to the same functions without the dispatcher.

Meaning shared by all: gallery rows at or past ``count`` score -1e30;
each query's top k come in the order (score descending, row index
ascending), so among equal scores the lowest index wins and, when k
exceeds the live rows, the padding rows follow in ascending order, as
``lax.top_k`` returns them. The float search scores ``queries .
gallery^T`` in f32 from the upcast operands; the int8 search quantizes the
queries per row and scores ``(f32(s8 . s8) * q_scale) * g_scale``, which
the kernel reproduces bit for bit.

Width: the kernels are built for D = 512 (``DIM``). The wrappers take any
width up to 512 and zero-pad queries (and a narrower gallery) to 512
before a launch. That is exact: zeros add nothing to an f32 sum or an s8
dot, and they change neither the gallery's stored row maxima nor
``quantize_rows_int8``'s per-query maximum, so the scores are those of the
unpadded search. ``GalleryStore`` keeps its rows 512 wide on the card for
that reason. Wider than 512 raises on every device (``check_width``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

NEG_INF = -1e30
DIM = 512           # embedding width the kernel is built for; narrower
#                     widths are zero-padded to it (see the module docstring)
MAX_K = 64          # the server caps /search at k <= 64
# batches from MMA_MIN_B on take the tensor-core pass 1 (topk_mma.cuh
# topk_partial_mma_kernel): MMA_QUERIES queries (MMA_QUERIES_F32 in f32,
# whose 64-query tile does not fit in shared memory) and row tiles of
# MMA_ROWS per CTA
MMA_MIN_B = 9
MMA_QUERIES = 64
MMA_QUERIES_F32 = 32
MMA_ROWS = 128


def cosine_topk_reference(gallery: torch.Tensor, queries: torch.Tensor,
                          count: int, k: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gallery (N, D), queries (B, D) -> (B, k) f32 scores, (B, k) int32
    indices. ``count`` masks the padding rows of a capacity-bucketed
    gallery. Computes in f32 from the upcast operands (a bf16 matmul would
    round the scores to bf16)."""
    sims = queries.float() @ gallery.float().T
    rows = torch.arange(gallery.shape[0], device=gallery.device)
    sims = sims.masked_fill(rows[None, :] >= count, NEG_INF)
    # torch.topk promises no order among ties; a stable descending sort
    # keeps equal scores in ascending index order
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def cosine_topk(gallery: torch.Tensor, queries: torch.Tensor, count: int,
                k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery search; see the module docstring for its meaning.

    CPU tensors run ``cosine_topk_reference``. CUDA tensors launch the
    kernel, on the current stream and without synchronizing; anything the
    kernel does not take raises. Queries narrower than the gallery are
    zero-padded to its width (the store's padded rows); a gallery narrower
    than 512 is padded too, into a copy: N * 512 elements of its dtype
    allocated and written on every call, which a caller that searches one
    gallery often avoids by keeping it 512 wide (``pad_width``), as
    ``GalleryStore`` does. Wider than 512 raises. ``cosine_topk.launches``
    counts the launches. Under ``torch.export`` it is the registered op
    ``facekit_torch::cosine_topk``, which runs the same two functions.
    """
    check_width("cosine_topk", gallery, queries)
    if torch.compiler.is_exporting():
        return torch.ops.facekit_torch.cosine_topk(gallery, queries,
                                                   int(count), int(k))
    if gallery.device.type == "cpu" and queries.device.type == "cpu":
        return cosine_topk_reference(
            gallery, pad_width(queries, gallery.shape[1]), count, k)
    return _cosine_topk_cuda(gallery, queries, int(count), int(k))


cosine_topk.launches = 0


def quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization, x ~= q * scale[:, None]
    (``facekit/ops/similarity.py:59-70``): f32 row amax, scale =
    max(amax, 1e-12) / 127, q = clip(round(x / scale), -127, 127) with a
    true division and round half to even, as ``jnp.round`` rounds. Returns
    (q int8 (N, D), scale f32 (N,))."""
    x = x.float()
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def cosine_topk_int8_reference(gallery_q: torch.Tensor,
                               gallery_scale: torch.Tensor,
                               queries: torch.Tensor, count: int, k: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gallery_q (N, D) int8 with per-row f32 scales (N,), f32 queries
    (B, D) -> (B, k) f32 scores, (B, k) int32 indices.

    The queries are quantized per row; the integer products are taken as
    an f32 product of the upcast operands, which is exact (every partial
    sum is an integer below 127**2 * D < 2**24) provided the product runs
    in full f32: on a CUDA tensor with TF32 allowed it raises."""
    if gallery_q.device.type == "cuda" and \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("cosine_topk_int8_reference needs full f32 "
                           "products: set torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    qq, qs = quantize_rows_int8(queries)
    acc = qq.float() @ gallery_q.float().T
    sims = acc * qs[:, None] * gallery_scale.float()[None, :]
    rows = torch.arange(gallery_q.shape[0], device=gallery_q.device)
    sims = sims.masked_fill(rows[None, :] >= count, NEG_INF)
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def cosine_topk_int8(gallery_q: torch.Tensor, gallery_scale: torch.Tensor,
                     queries: torch.Tensor, count: int, k: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8 gallery; see the module docstring for its
    meaning.

    CPU tensors run ``cosine_topk_int8_reference``. CUDA tensors quantize
    the f32 queries with plain torch ops (as facekit does outside its
    ``pallas_call``, ``similarity.py:198``) and launch the kernel, on the
    current stream and without synchronizing; anything the kernel does not
    take raises. Widths as in ``cosine_topk``: the padded copy of a
    narrower gallery writes N * 512 bytes per call.
    ``cosine_topk_int8.launches`` counts the launches. Under
    ``torch.export`` it is the registered op
    ``facekit_torch::cosine_topk_int8``.
    """
    check_width("cosine_topk_int8", gallery_q, queries)
    if torch.compiler.is_exporting():
        return torch.ops.facekit_torch.cosine_topk_int8(
            gallery_q, gallery_scale, queries, int(count), int(k))
    if all(t.device.type == "cpu" for t in (gallery_q, gallery_scale,
                                             queries)):
        return cosine_topk_int8_reference(
            gallery_q, gallery_scale, pad_width(queries, gallery_q.shape[1]),
            count, k)
    return _cosine_topk_int8_cuda(gallery_q, gallery_scale, queries,
                                  int(count), int(k))


cosine_topk_int8.launches = 0


def check_width(name: str, gallery: torch.Tensor,
                queries: torch.Tensor) -> None:
    """Raise unless the widths are ones the kernels take: 2-D, each at most
    ``DIM`` wide, the queries no wider than the gallery."""
    if gallery.dim() != 2 or queries.dim() != 2:
        raise ValueError(f"{name}: gallery and queries must be 2-D")
    d, dq = gallery.shape[1], queries.shape[1]
    if d > DIM or dq > d:
        raise ValueError(f"{name}: gallery width {d}, queries {dq}; the "
                         f"searches take widths up to {DIM}, the queries no "
                         "wider than the gallery")


def pad_width(x: torch.Tensor, width: int = DIM) -> torch.Tensor:
    """(R, D) with D <= ``width`` -> (R, width), zeros past column D:
    ``x`` itself when it is that wide, else a new contiguous tensor."""
    d = x.shape[1]
    if d > width:
        raise ValueError(f"width {d}: at most {width} expected")
    if d == width:
        return x
    out = x.new_zeros((x.shape[0], width))
    out[:, :d] = x
    return out


def _check(gallery: torch.Tensor, queries: torch.Tensor, count: int, k: int):
    if gallery.device.type != "cuda" or queries.device != gallery.device:
        raise ValueError(f"cosine_topk: gallery on {gallery.device} and "
                         f"queries on {queries.device}; both must be on one "
                         "CUDA device (or both on the CPU)")
    if gallery.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"cosine_topk: gallery dtype {gallery.dtype}; the "
                        "kernel takes bfloat16 or float32")
    if queries.dtype != gallery.dtype:
        raise TypeError(f"cosine_topk: queries {queries.dtype} != gallery "
                        f"{gallery.dtype}; cast queries to the gallery dtype")
    if not (gallery.is_contiguous() and queries.is_contiguous()):
        raise ValueError("cosine_topk: gallery and queries must be contiguous")
    if gallery.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("cosine_topk: gallery and queries must be 16-byte "
                         "aligned")
    n, b = gallery.shape[0], queries.shape[0]
    if b < 1:
        raise ValueError("cosine_topk: empty batch")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"cosine_topk: k={k} outside [1, min({MAX_K}, N={n})]")
    if not 0 <= count <= n:
        raise ValueError(f"cosine_topk: count={count} outside [0, N={n}]")


def _check_int8(gallery_q: torch.Tensor, gallery_scale: torch.Tensor,
                queries: torch.Tensor, count: int, k: int):
    dev = gallery_q.device
    if dev.type != "cuda" or gallery_scale.device != dev or \
            queries.device != dev:
        raise ValueError(f"cosine_topk_int8: gallery on {dev}, scales on "
                         f"{gallery_scale.device}, queries on "
                         f"{queries.device}; all must be on one CUDA device "
                         "(or all on the CPU)")
    if gallery_q.dtype != torch.int8 or gallery_scale.dtype != torch.float32:
        raise TypeError(f"cosine_topk_int8: gallery {gallery_q.dtype} with "
                        f"scales {gallery_scale.dtype}; the kernel takes "
                        "int8 rows with float32 scales")
    if queries.dtype != torch.float32:
        raise TypeError(f"cosine_topk_int8: queries {queries.dtype}; the "
                        "kernel takes float32 queries")
    if gallery_scale.shape != gallery_q.shape[:1]:
        raise ValueError("cosine_topk_int8: gallery (N, D), scales (N,) and "
                         "queries (B, D) expected")
    if not (gallery_q.is_contiguous() and gallery_scale.is_contiguous()):
        raise ValueError("cosine_topk_int8: gallery and scales must be "
                         "contiguous")
    if gallery_q.data_ptr() % 16:
        raise ValueError("cosine_topk_int8: gallery must be 16-byte aligned")
    n, b = gallery_q.shape[0], queries.shape[0]
    if b < 1:
        raise ValueError("cosine_topk_int8: empty batch")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"cosine_topk_int8: k={k} outside [1, min({MAX_K}, "
                         f"N={n})]")
    if not 0 <= count <= n:
        raise ValueError(f"cosine_topk_int8: count={count} outside "
                         f"[0, N={n}]")


def _mma_queries(dtype: torch.dtype, b: int) -> int:
    """Queries per CTA of the tensor-core pass 1 that a search over a
    gallery of ``dtype`` (bfloat16, float32 or int8) runs at batch ``b``,
    or 0 where it runs its CUDA-core pass 1: the C entry points' rule,
    B > 8 on tensor cores."""
    if b < MMA_MIN_B:
        return 0
    return MMA_QUERIES_F32 if dtype == torch.float32 else MMA_QUERIES


def _search_plan(n_rows: int, b: int, mma_queries: int, sms: int, k: int
                 ) -> Tuple[int, int]:
    """(rows per CTA, chunks) of pass 1 over ``n_rows`` rows for a batch of
    ``b`` and top ``k`` on a card of ``sms`` SMs; rows per CTA times chunks
    covers ``n_rows``.

    ``mma_queries`` (``_mma_queries``) > 0: pass 1 is the tensor-core
    kernel, with CTAs of that many queries, each chunk a multiple of
    MMA_ROWS rows, and about one CTA per SM over the (query tiles, chunks)
    grid, down to one chunk of all the rows per tile once the query tiles
    outnumber half the SMs. Any batch fits that grid. 0: the CUDA-core kernels (every type at b <= 8), each chunk a
    multiple of 256 rows (32 per warp): about four CTAs per SM at k = 1,
    two at k > 1, where a chunk's lists fill with its first rows whatever
    its length, so longer chunks spend less of their time filling and give
    pass 2 half the partials."""
    if mma_queries:
        q_tiles = -(-b // mma_queries)
        per = -(-n_rows // max(1, sms // q_tiles))
        rows_per_cta = -(-per // MMA_ROWS) * MMA_ROWS
    else:
        per = -(-n_rows // ((4 if k == 1 else 2) * sms))
        rows_per_cta = max(256, -(-per // 256) * 256)
    return rows_per_cta, -(-n_rows // rows_per_cta)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _library():
    """The kernel's C entry point, built at first use."""
    from facekit_torch.ops import _build
    fn = _build.load("cosine_topk").facekit_cosine_topk
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _library_int8():
    """The int8 kernel's C entry point, built at first use."""
    from facekit_torch.ops import _build
    fn = _build.load("cosine_topk_int8").facekit_cosine_topk_int8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _cosine_topk_cuda(gallery, queries, count, k):
    check_width("cosine_topk", gallery, queries)
    gallery, queries = pad_width(gallery), pad_width(queries)
    _check(gallery, queries, count, k)
    n, b = gallery.shape[0], queries.shape[0]
    # rows count..count+k-1 (score -1e30, ascending index) outrank every
    # later padding row, so no row past count + k can reach the top k
    n_rows = min(n, count + k)
    dev = gallery.device
    rows_per_cta, chunks = _search_plan(
        n_rows, b, _mma_queries(gallery.dtype, b), _sms(dev), k)
    part_v = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(gallery.data_ptr(), queries.data_ptr(),
                 int(gallery.dtype == torch.bfloat16), n_rows, count, b, k,
                 rows_per_cta, chunks, part_v.data_ptr(), part_i.data_ptr(),
                 out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cosine_topk: kernel launch failed with CUDA "
                           f"error {err}")
    cosine_topk.launches += 1
    return out_v, out_i


def _cosine_topk_int8_cuda(gallery_q, gallery_scale, queries, count, k):
    check_width("cosine_topk_int8", gallery_q, queries)
    gallery_q, queries = pad_width(gallery_q), pad_width(queries)
    _check_int8(gallery_q, gallery_scale, queries, count, k)
    qq, qs = quantize_rows_int8(queries)      # plain torch ops, new tensors
    n, b = gallery_q.shape[0], queries.shape[0]
    n_rows = min(n, count + k)                # see _cosine_topk_cuda
    dev = gallery_q.device
    rows_per_cta, chunks = _search_plan(
        n_rows, b, _mma_queries(gallery_q.dtype, b), _sms(dev), k)
    part_v = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _library_int8()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(gallery_q.data_ptr(), gallery_scale.data_ptr(),
                 qq.data_ptr(), qs.data_ptr(), n_rows, count, b, k,
                 rows_per_cta, chunks, part_v.data_ptr(), part_i.data_ptr(),
                 out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cosine_topk_int8: kernel launch failed with CUDA "
                           f"error {err}")
    cosine_topk_int8.launches += 1
    return out_v, out_i


# -- the two searches as registered ops, for torch.export: the CPU
#    implementation is the plain version, the CUDA one the kernel's wrapper

@torch.library.custom_op("facekit_torch::cosine_topk", mutates_args=(),
                         device_types="cpu")
def _cosine_topk_op(gallery: torch.Tensor, queries: torch.Tensor,
                    count: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return cosine_topk_reference(gallery, queries, count, k)


_cosine_topk_op.register_kernel("cuda")(_cosine_topk_cuda)


@_cosine_topk_op.register_fake
def _(gallery, queries, count, k):
    return _topk_outputs(queries, k)


@torch.library.custom_op("facekit_torch::cosine_topk_int8", mutates_args=(),
                         device_types="cpu")
def _cosine_topk_int8_op(gallery_q: torch.Tensor, gallery_scale: torch.Tensor,
                         queries: torch.Tensor, count: int, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return cosine_topk_int8_reference(gallery_q, gallery_scale, queries,
                                      count, k)


_cosine_topk_int8_op.register_kernel("cuda")(_cosine_topk_int8_cuda)


@_cosine_topk_int8_op.register_fake
def _(gallery_q, gallery_scale, queries, count, k):
    return _topk_outputs(queries, k)


def _topk_outputs(queries: torch.Tensor, k: int):
    """Empty (B, k) f32 scores and int32 indices beside ``queries``."""
    b = queries.shape[0]
    return (queries.new_empty((b, k), dtype=torch.float32),
            queries.new_empty((b, k), dtype=torch.int32))
