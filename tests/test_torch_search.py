"""facekit_torch's gallery search against facekit's.

On the CPU the port's plain search must equal ``cosine_topk_xla`` and
``cosine_topk_pallas`` in interpret mode (as tests/test_similarity.py runs
them) index for index. The kernel against the plain version is in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.ops.similarity import cosine_topk_pallas, cosine_topk_xla
from facekit_torch.ops.similarity import cosine_topk_reference

VAL_ATOL = {"float32": 1e-6, "bfloat16": 1e-5}   # f32 sums in another order
N = 1000


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _data(seed, n=N, b=5, ties=False):
    rng = np.random.default_rng(seed)
    g = _unit(rng.normal(size=(n, 512))).astype(np.float32)
    q = _unit(rng.normal(size=(b, 512))).astype(np.float32)
    if ties:
        # rows 600.. duplicate rows 0..; queries are those rows, so every
        # query has two equal top scores and the lower index must win
        g[600:600 + b] = g[:b]
        q = g[:b].copy()
    return g, q


def _both(g, q, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ((jnp.asarray(g, jd), jnp.asarray(q, jd)),
            (torch.tensor(g).to(td), torch.tensor(q).to(td)))


def _assert_same(ours, ref, dtype):
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=0, atol=VAL_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("count", [N, 777])
def test_plain_search_matches_xla_and_pallas(dtype, k, count):
    (gj, qj), (gt, qt) = _both(*_data(k + count), dtype)
    ours = cosine_topk_reference(gt, qt, count, k)
    assert ours[0].dtype == torch.float32 and ours[1].dtype == torch.int32
    _assert_same(ours, cosine_topk_xla(gj, qj, jnp.int32(count), k=k), dtype)
    _assert_same(ours, cosine_topk_pallas(gj, qj, jnp.int32(count), k=k,
                                          tile_n=256, interpret=True), dtype)
    assert ours[1].max() < count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [33, 64])
@pytest.mark.parametrize("k", [1, 64])
@pytest.mark.parametrize("count", [N, 777])
def test_plain_search_matches_xla_and_pallas_large_batch(dtype, b, k, count):
    """The batches above 8 that the card serves with its tensor-core kernel
    (bf16) or its CUDA-core kernel (f32): one query tile of the kernel and a
    ragged one. Entries are multiples of 1/64 up to 1/8 (exact in bf16), so
    every partial sum is exact in f32 whatever the order: at b * k
    positions, random unit rows hold near-ties below the sums' rounding
    (XLA and PyTorch swapped one such pair at b=64, k=64), and here they
    are true ties, which must resolve lowest index first in all three."""
    rng = np.random.default_rng(b + k + count)
    g, q = (rng.integers(-8, 9, size=(r, 512)).astype(np.float32) / 64
            for r in (N, b))
    (gj, qj), (gt, qt) = _both(g, q, dtype)
    ours = cosine_topk_reference(gt, qt, count, k)
    assert ours[0].shape == (b, k) and ours[1].dtype == torch.int32
    _assert_same(ours, cosine_topk_xla(gj, qj, jnp.int32(count), k=k), dtype)
    _assert_same(ours, cosine_topk_pallas(gj, qj, jnp.int32(count), k=k,
                                          tile_n=256, interpret=True), dtype)
    assert ours[1].max() < count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_search_ties_lowest_index_first(dtype):
    (gj, qj), (gt, qt) = _both(*_data(7, ties=True), dtype)
    ours = cosine_topk_reference(gt, qt, N, 2)
    np.testing.assert_array_equal(ours[1].numpy(),
                                  np.stack([np.arange(5), 600 + np.arange(5)], 1))
    _assert_same(ours, cosine_topk_xla(gj, qj, jnp.int32(N), k=2), dtype)
    _assert_same(ours, cosine_topk_pallas(gj, qj, jnp.int32(N), k=2,
                                          tile_n=256, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count,k", [(3, 8), (2, 4)])
def test_plain_search_k_exceeds_count(dtype, count, k):
    """Past the live rows the padding rows follow in ascending order, as
    lax.top_k returns them."""
    (gj, qj), (gt, qt) = _both(*_data(11), dtype)
    ours = cosine_topk_reference(gt, qt, count, k)
    np.testing.assert_array_equal(ours[1].numpy()[:, count:],
                                  np.tile(np.arange(count, k), (5, 1)))
    _assert_same(ours, cosine_topk_xla(gj, qj, jnp.int32(count), k=k), dtype)
    _assert_same(ours, cosine_topk_pallas(gj, qj, jnp.int32(count), k=k,
                                          tile_n=256, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_search_cutoff_tie(dtype):
    """k = 64 where the 64th and 65th scores tie between rows far apart:
    the lower index takes the 64th place, in the port's plain search as
    in ``lax.top_k`` (XLA) and the Pallas kernel. The card's search must
    keep this order where it prunes at the cutoff."""
    g, q = _data(37)
    _, plain = _both(g, q, dtype)
    order = cosine_topk_reference(*plain, N, N)[1][0].numpy()
    # row c, ranked past 65th and 300 rows or more from the 64th row a,
    # becomes a copy of a: the places above 64th stay as they were
    a = int(order[63])
    c = next(int(r) for r in order[65:] if abs(int(r) - a) >= 300)
    g[c] = g[a]
    (gj, qj), (gt, qt) = _both(g, q, dtype)
    for k in (64, 65):
        ours = cosine_topk_reference(gt, qt, N, k)
        _assert_same(ours, cosine_topk_xla(gj, qj, jnp.int32(N), k=k), dtype)
        _assert_same(ours, cosine_topk_pallas(gj, qj, jnp.int32(N), k=k,
                                              tile_n=256, interpret=True),
                     dtype)
    np.testing.assert_array_equal(ours[1][0, 63:65].numpy(),
                                  [min(a, c), max(a, c)])
    assert ours[0][0, 63] == ours[0][0, 64]
