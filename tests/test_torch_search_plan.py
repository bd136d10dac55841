"""The launch plan of facekit_torch's gallery-search kernels.

``_search_plan`` and the route rule ``_mma_queries`` are pure functions of
the shapes and the card's SM count, so they are checked here on the CPU;
the kernels themselves are in tests/test_torch_kernels.py. At B > 8 every
search runs ``topk_partial_wgmma_kernel`` (topk_wgmma.cuh): bf16 and int8
with the wgmma's M = MMA_QUERIES queries a CTA and N = MMA_ROWS rows a
tile, f32 with the roles swapped (the rows as M, two warpgroups of 64,
MMA_QUERIES_F32 queries as N); each CTA writes one partial list a query,
so a query has ``chunks`` partials. Imports neither JAX nor facekit.
"""

import pytest
import torch

from facekit_torch.ops.similarity import (MMA_MIN_B, MMA_QUERIES,
                                          MMA_QUERIES_F32, MMA_ROWS,
                                          PASS1_SMEM, _mma_queries,
                                          _search_plan, pass1_layout)

SMS = 132                      # an H100 SXM
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}


def _cuda_core_plan(n_rows, sms, k):
    """The plan of the CUDA-core pass 1 (every type at B <= 8), each chunk
    a multiple of 256 rows: about four CTAs per SM at k = 1 (the plan
    before the batched selection), two at k > 1."""
    per = -(-n_rows // ((4 if k == 1 else 2) * sms))
    rows_per_cta = max(256, -(-per // 256) * 256)
    return rows_per_cta, -(-n_rows // rows_per_cta)


def _tensor_cores(kind, b):
    """Whether the wrappers run pass 1 on tensor cores: every type's
    (``kind``) batches from MMA_MIN_B on, as the C entry points' rule
    B > 8."""
    return b >= MMA_MIN_B


def _queries(kind, b):
    """Queries per CTA of the pass 1 a ``kind`` search runs at batch b."""
    return _mma_queries(DTYPES[kind], b)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("b", [1, 8, 9, 32, 64, 256])
@pytest.mark.parametrize("n_rows", [33, 1000, 1 << 20])
@pytest.mark.parametrize("k", [1, 64])
def test_search_plan(n_rows, b, kind, k):
    tensor_cores = _tensor_cores(kind, b)
    rows_per_cta, chunks = _search_plan(n_rows, b, _queries(kind, b), SMS, k)
    assert rows_per_cta * chunks >= n_rows
    assert (chunks - 1) * rows_per_cta < n_rows       # no empty chunk
    if n_rows == 33:
        assert chunks == 1
    if tensor_cores:
        assert rows_per_cta % MMA_ROWS == 0
        # about one CTA per SM over the (query tiles, chunks) grid, with
        # f32's own query-tile height
        height = MMA_QUERIES_F32 if kind == "f32" else MMA_QUERIES
        assert -(-b // height) * chunks <= SMS
    else:
        assert (rows_per_cta, chunks) == _cuda_core_plan(n_rows, SMS, k)


def test_search_plan_fills_the_card_at_full_gallery():
    """At the top gallery bucket the tensor-core path launches one wave:
    4 query tiles x 33 chunks at B = 256, 131 chunks at B = 32 (bf16) and
    B = 64 (int8, the served /recognize bucket 64); in f32, 8 query tiles
    of 32 x 16 chunks at B = 256 and one tile x 131 chunks at B = 32."""
    for k in (1, 64):          # the tensor-core plan does not take k
        assert _search_plan(1 << 20, 256, _queries("bf16", 256),
                            SMS, k) == (31872, 33)
        assert _search_plan(1 << 20, 32, _queries("bf16", 32),
                            SMS, k) == (8064, 131)
        assert _search_plan(1 << 20, 64, _queries("int8", 64),
                            SMS, k) == (8064, 131)
        assert _search_plan(1 << 20, 256, _queries("int8", 256),
                            SMS, k) == (31872, 33)
        assert _search_plan(1 << 20, 256, _queries("f32", 256),
                            SMS, k) == (65536, 16)
        assert _search_plan(1 << 20, 32, _queries("f32", 32),
                            SMS, k) == (8064, 131)
    assert MMA_MIN_B == 9          # the C entry points' rule: B > 8


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("b", [1, 8])
def test_small_batch_plan_at_full_gallery(kind, b):
    """At the top gallery bucket the CUDA-core pass 1 keeps its k = 1 plan
    (512 chunks of 2,048 rows, about four CTAs per SM) and at k > 1 takes
    256 chunks of 4,096 rows (about two per SM; at k = 64 pass 2 then
    meets 16,384 partials a query, where it met 32,768)."""
    q = _queries(kind, b)
    assert q == 0
    assert _search_plan(1 << 20, b, q, SMS, 1) == (2048, 512)
    for k in (2, 5, 64):
        assert _search_plan(1 << 20, b, q, SMS, k) == (4096, 256)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("b", [1, 8, 9, 33, 256])
def test_route_rule(kind, b):
    """Which batches take the tensor-core pass 1, and with how many queries
    a CTA: every type above 8 (the C entry points' B > 8), f32 with its own
    tile (the wgmma's N: 64 f32 queries split into hi and lo do not fit in
    shared memory), bf16 and int8 with MMA_QUERIES; batches up to 8 take
    the CUDA-core pass 1 (0)."""
    height = MMA_QUERIES_F32 if kind == "f32" else MMA_QUERIES
    want = height if b > 8 else 0
    assert _mma_queries(DTYPES[kind], b) == want
    assert bool(want) == _tensor_cores(kind, b)
    assert MMA_QUERIES_F32 < MMA_QUERIES


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("b", [257, 512, 8448, 20000])
@pytest.mark.parametrize("n_rows", [33, 1000, 1 << 20])
@pytest.mark.parametrize("k", [1, 64])
def test_search_plan_past_256_queries(n_rows, b, kind, k):
    """Batches past 256 queries take the tensor-core pass 1 with the same
    rule: the chunks cover the rows, none is empty, and the (query tiles,
    chunks) grid stays about one CTA per SM until the query tiles alone
    outnumber the SMs (then one chunk per tile)."""
    q = _queries(kind, b)
    height = MMA_QUERIES_F32 if kind == "f32" else MMA_QUERIES
    assert q == height
    rows_per_cta, chunks = _search_plan(n_rows, b, q, SMS, k)
    q_tiles = -(-b // height)
    assert rows_per_cta % MMA_ROWS == 0
    assert rows_per_cta * chunks >= n_rows
    assert (chunks - 1) * rows_per_cta < n_rows
    assert q_tiles * chunks <= max(SMS, q_tiles)
    if q_tiles > SMS // 2:
        assert chunks == 1


def test_search_plan_at_512_queries_full_gallery():
    """B = 512 at the top gallery bucket: 8 query tiles x 16 chunks in bf16
    and int8, 16 f32 tiles of 32 x 8 chunks; B = 257 adds a fifth (ninth
    in f32) tile with one query, and the chunks shrink to fit."""
    for k in (1, 64):
        assert _search_plan(1 << 20, 512, _queries("bf16", 512),
                            SMS, k) == (65536, 16)
        assert _search_plan(1 << 20, 512, _queries("int8", 512),
                            SMS, k) == (65536, 16)
        assert _search_plan(1 << 20, 512, _queries("f32", 512),
                            SMS, k) == (131072, 8)
        assert _search_plan(1 << 20, 257, _queries("bf16", 257),
                            SMS, k) == (40448, 26)
        assert _search_plan(1 << 20, 257, _queries("f32", 257),
                            SMS, k) == (75008, 14)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_query_tile_is_the_kernels(kind):
    """The queries a CTA that the plan takes are those of the kernel's
    query tile (``pass1_layout``): f32 a hi and a lo tile of
    MMA_QUERIES_F32 rows of 2,048 bytes (the wgmma's N, a multiple of 8
    up to 256), bf16 and int8 one of MMA_QUERIES rows (its M, 64)."""
    dtype = DTYPES[kind]
    per_cta = _mma_queries(dtype, 256)
    row = 512 * torch.empty((), dtype=dtype).element_size()
    queries = pass1_layout(dtype, 1)["queries"][1]
    assert queries == (2 if kind == "f32" else 1) * per_cta * row
    if kind == "f32":
        assert per_cta % 8 == 0 and per_cta <= 256
        assert 2 * MMA_QUERIES * row > PASS1_SMEM     # a 64-query tile
    else:
        assert per_cta == 64
