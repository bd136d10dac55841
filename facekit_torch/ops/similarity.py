"""Cosine-similarity gallery search: f32 scores fused with top-k.

Port of ``facekit/ops/similarity.py``. Two functions with one meaning:

  * ``cosine_topk_reference`` — the plain PyTorch version of
    ``cosine_topk_xla`` (``similarity.py:42-56``); the CPU path and the
    yardstick the kernel is held against;
  * ``cosine_topk`` — the wrapper: for CUDA tensors it launches the
    hand-written Hopper kernel ``ops/csrc/cosine_topk.cu`` (the port of the
    TPU kernel ``cosine_topk_pallas``) or raises; for CPU tensors it runs
    the plain version.

Meaning shared by both: scores are ``queries . gallery^T`` computed in f32
from the upcast operands; gallery rows at or past ``count`` score -1e30;
each query's top k come in the order (score descending, row index
ascending), so among equal scores the lowest index wins and, when k
exceeds the live rows, the padding rows follow in ascending order, as
``lax.top_k`` returns them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

NEG_INF = -1e30
DIM = 512           # embedding width the kernel is built for
MAX_K = 64          # the server caps /search at k <= 64
MAX_B = 256         # largest query batch (64 frames x 4 face slots)


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
    kernel does not take raises. ``cosine_topk.launches`` counts the
    launches.
    """
    if gallery.device.type == "cpu" and queries.device.type == "cpu":
        return cosine_topk_reference(gallery, queries, count, k)
    return _cosine_topk_cuda(gallery, queries, int(count), int(k))


cosine_topk.launches = 0


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
    if gallery.dim() != 2 or queries.dim() != 2:
        raise ValueError("cosine_topk: gallery and queries must be 2-D")
    if gallery.shape[1] != DIM or queries.shape[1] != DIM:
        raise ValueError(f"cosine_topk: width {gallery.shape[1]}/"
                         f"{queries.shape[1]}; the kernel takes D={DIM}")
    if not (gallery.is_contiguous() and queries.is_contiguous()):
        raise ValueError("cosine_topk: gallery and queries must be contiguous")
    if gallery.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("cosine_topk: gallery and queries must be 16-byte "
                         "aligned")
    n, b = gallery.shape[0], queries.shape[0]
    if not 1 <= b <= MAX_B:
        raise ValueError(f"cosine_topk: batch {b} outside [1, {MAX_B}]")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"cosine_topk: k={k} outside [1, min({MAX_K}, N={n})]")
    if not 0 <= count <= n:
        raise ValueError(f"cosine_topk: count={count} outside [0, N={n}]")


def _launch_shape(n_rows: int, device: torch.device) -> Tuple[int, int]:
    """(rows per CTA, chunks): about four CTAs per SM, each a multiple of
    256 rows (32 per warp)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-n_rows // (4 * sms))
    rows_per_cta = max(256, -(-per // 256) * 256)
    return rows_per_cta, -(-n_rows // rows_per_cta)


@functools.cache
def _library():
    """The kernel's C entry point, built at first use."""
    from facekit_torch.ops import _build
    fn = _build.load("cosine_topk").facekit_cosine_topk
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _cosine_topk_cuda(gallery, queries, count, k):
    _check(gallery, queries, count, k)
    n, b = gallery.shape[0], queries.shape[0]
    # rows count..count+k-1 (score -1e30, ascending index) outrank every
    # later padding row, so no row past count + k can reach the top k
    n_rows = min(n, count + k)
    rows_per_cta, chunks = _launch_shape(n_rows, gallery.device)
    dev = gallery.device
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
