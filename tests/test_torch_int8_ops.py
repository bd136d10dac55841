"""facekit_torch's int8 ops against facekit's, on the CPU.

The quantizers, the int8 conv and the int8 search must equal facekit's bit
for bit: every step is either exact integer arithmetic or the same f32
operations in the same order. The plain s8 convolution must also equal
the TPU kernel it replaces, ``conv_s8_s2_pallas``'s body run in interpret
mode as its own script runs it, and that script's XLA reference.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from facekit.models import layers as JL
from facekit.ops.similarity import (cosine_topk_int8 as jax_topk_int8,
                                    cosine_topk_int8_pallas,
                                    quantize_rows_int8 as jax_quantize_rows)
from facekit_torch.models import layers as TL
from facekit_torch.ops.conv_s8 import conv_s8_reference
from facekit_torch.ops.similarity import (cosine_topk_int8,
                                          cosine_topk_int8_reference,
                                          quantize_rows_int8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1000


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _equal(ours: torch.Tensor, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# -- quantizers ----------------------------------------------------------------

def test_quantize_rows_int8_equals_facekit():
    rng = np.random.default_rng(0)
    x = _unit(rng.normal(size=(64, 512)))
    x[3] = 0.0                                   # the 1e-12 floor
    x[5] = 0.0                                   # scale 127 / 127 = 1, so
    x[5, :5] = [0.5, -0.5, 1.5, 2.5, 127.0]      # halves round to even
    q, s = quantize_rows_int8(torch.tensor(x))
    np.testing.assert_array_equal(q[5, :5].numpy(), [0, 0, 2, 2, 127])
    rq, rs = jax_quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _equal(q, rq)
    _equal(s, rs)


@pytest.mark.parametrize("shape", [(64, 3, 3, 3), (128, 64, 1, 1),
                                   (64, 64, 3, 3)])
def test_quantize_conv_weight_equals_facekit(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(0, 0.1, size=shape).astype(np.float32)      # OIHW
    w[1] = 0.0                                                 # dead channel
    q, s = TL.quantize_conv_weight(torch.tensor(w))
    rq, rs = JL.quantize_conv_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert q.dtype == torch.int8 and q.shape == shape
    _equal(q, np.asarray(rq).transpose(3, 2, 0, 1))
    _equal(s, rs)


# -- the int8 conv ---------------------------------------------------------------

# (C_in, kernel, stride, padding, static ascale)
CONV_CASES = [(3, 3, 1, 1, False), (3, 3, 2, 1, True), (64, 3, 2, 1, False),
              (64, 3, 1, 0, True), (64, 1, 2, 0, False), (3, 1, 1, 0, True),
              (64, 1, 1, 1, True), (64, 3, 1, 1, True)]


@pytest.mark.parametrize("c,ks,stride,pad,static", CONV_CASES)
def test_conv2d_int8_equals_facekit(c, ks, stride, pad, static):
    rng = np.random.default_rng(c + ks + stride + pad + static)
    x = rng.normal(size=(2, 11, 9, c)).astype(np.float32)
    x[1] *= 30.0                    # per-sample scales differ
    w = rng.normal(0, 0.1, size=(64, c, ks, ks)).astype(np.float32)
    rq, rs = JL.quantize_conv_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    ascale = np.float32(max(float(np.abs(x).max() * 1.25), 1e-12) / 127.0) \
        if static else None
    ref = JL.conv2d_int8(jnp.asarray(x), rq, rs, stride=stride, padding=pad,
                         ascale=None if ascale is None else jnp.asarray(ascale))
    q, s = TL.quantize_conv_weight(torch.tensor(w))
    ours = TL.conv2d_int8(torch.tensor(x), q, s, stride=stride, padding=pad,
                          ascale=None if ascale is None
                          else torch.tensor(ascale))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    _equal(ours, ref)


def _kernel4_script():
    spec = importlib.util.spec_from_file_location(
        "pallas_s8_stride2_conv",
        os.path.join(REPO, "docs", "experiments", "pallas_s8_stride2_conv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_conv_equals_kernel4_and_its_xla_reference():
    """Kernel #4's shape (112x112, C = 64, 3x3, stride 2, pad 1) at n = 2:
    the plain s8 conv equals ``conv_s8_s2_xla`` and the Pallas kernel's
    body run in interpret mode exactly as the script's ``--interpret``
    branch runs it (pallas_s8_stride2_conv.py:123-139)."""
    m = _kernel4_script()
    n = 2
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(-127, 128, (n, m.H, m.W, m.C)), jnp.int8)
    wq = jnp.asarray(rng.integers(-127, 128, (3, 3, m.C, m.C)), jnp.int8)
    got = pl.pallas_call(
        m._kernel,
        out_shape=jax.ShapeDtypeStruct((n, m.OH, m.OW, m.C), jnp.int32),
        grid=(n,),
        in_specs=[pl.BlockSpec((1, m.H // 2, 2, m.W // 2, 2 * m.C),
                               lambda i: (i, 0, 0, 0, 0)),
                  pl.BlockSpec((12 * m.C, m.C), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, m.OH, m.OW, m.C), lambda i: (i, 0, 0, 0)),
        interpret=True)(x.reshape(n, m.H // 2, 2, m.W // 2, 2 * m.C),
                        m.pack_weights(wq))
    ref = m.conv_s8_s2_xla(x, wq)
    ours = conv_s8_reference(torch.tensor(np.asarray(x)),
                             torch.tensor(np.asarray(wq).transpose(3, 0, 1, 2)),
                             stride=2, padding=1)
    assert ours.dtype == torch.int32 and ours.shape == (n, m.OH, m.OW, m.C)
    _equal(ours, ref)
    _equal(ours, got)


# -- the int8 search -------------------------------------------------------------

def _search_data(seed, b=5, ties=False, grid_queries=False):
    """(facekit's, the port's) arguments of an int8 search over N random
    unit rows. ``grid_queries``: the queries are integers in [-127, 127]
    times 2**-9, each row with one entry of magnitude 127, so that their
    int8 scales are 2**-9 exactly. facekit's jitted quantizer can round the
    scales of random rows one ulp away from the plain division (XLA on the
    CPU did at b = 64 and for the 33 tie rows), which the plain version
    does not copy."""
    rng = np.random.default_rng(seed)
    g = _unit(rng.normal(size=(N, 512)))
    q = _unit(rng.normal(size=(b, 512)))
    if grid_queries:
        q = rng.integers(-126, 127, size=(b, 512)).astype(np.float32)
        q[np.arange(b), rng.integers(0, 512, b)] = rng.choice([-127, 127], b)
        q = (q * 2.0 ** -9).astype(np.float32)
    if ties:
        # rows 600.. duplicate rows 0..; queries are those rows, so every
        # query has two equal top scores and the lower index must win
        if grid_queries:
            g[:b] = q
        g[600:600 + b] = g[:b]
        q = g[:b].copy()
    gq, gs = jax_quantize_rows(jnp.asarray(g))
    return (gq, gs, jnp.asarray(q)), (torch.tensor(np.asarray(gq)),
                                      torch.tensor(np.asarray(gs)),
                                      torch.tensor(q))


def _same_search(ours, jargs, count, k):
    """Scores bit-equal, indices equal, to facekit's XLA and Pallas (in
    interpret mode) int8 searches."""
    for ref in (jax_topk_int8(*jargs, jnp.int32(count), k=k),
                cosine_topk_int8_pallas(*jargs, jnp.int32(count), k=k,
                                        tile_n=512, interpret=True)):
        _equal(ours[1], ref[1])
        _equal(ours[0], ref[0])


@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("count", [N, 777])
def test_plain_int8_search_equals_facekit(k, count):
    jargs, targs = _search_data(k + count)
    ours = cosine_topk_int8_reference(*targs, count, k)
    assert ours[0].dtype == torch.float32 and ours[1].dtype == torch.int32
    _same_search(ours, jargs, count, k)
    assert ours[1].max() < count
    for a, b in zip(cosine_topk_int8(*targs, count, k), ours):   # CPU wrapper
        assert torch.equal(a, b)


@pytest.mark.parametrize("b", [33, 64])
@pytest.mark.parametrize("k", [1, 64])
@pytest.mark.parametrize("count", [N, 777])
def test_plain_int8_search_equals_facekit_large_batch(b, k, count):
    """Batches above 8, which the kernel runs on tensor cores: one m16 tile
    past a full query pair (33) and a full 64-query tile, as in
    ``test_plain_int8_search_equals_facekit``."""
    jargs, targs = _search_data(b + k + count, b=b, grid_queries=True)
    ours = cosine_topk_int8_reference(*targs, count, k)
    _same_search(ours, jargs, count, k)
    assert ours[1].max() < count
    for a, c in zip(cosine_topk_int8(*targs, count, k), ours):  # CPU wrapper
        assert torch.equal(a, c)


def test_plain_int8_search_ties_lowest_index_first():
    jargs, targs = _search_data(7, ties=True)
    ours = cosine_topk_int8_reference(*targs, N, 2)
    np.testing.assert_array_equal(ours[1].numpy(),
                                  np.stack([np.arange(5), 600 + np.arange(5)], 1))
    assert torch.equal(ours[0][:, 0], ours[0][:, 1])
    _same_search(ours, jargs, N, 2)


def test_plain_int8_search_ties_lowest_index_first_large_batch():
    """The tie case at 33 queries (grid rows, see ``_search_data``)."""
    b = 33
    jargs, targs = _search_data(8, b=b, ties=True, grid_queries=True)
    ours = cosine_topk_int8_reference(*targs, N, 2)
    np.testing.assert_array_equal(ours[1].numpy(),
                                  np.stack([np.arange(b), 600 + np.arange(b)], 1))
    assert torch.equal(ours[0][:, 0], ours[0][:, 1])
    _same_search(ours, jargs, N, 2)


@pytest.mark.parametrize("count,k", [(3, 8), (2, 4)])
def test_plain_int8_search_k_exceeds_count(count, k):
    jargs, targs = _search_data(11)
    ours = cosine_topk_int8_reference(*targs, count, k)
    np.testing.assert_array_equal(ours[1].numpy()[:, count:],
                                  np.tile(np.arange(count, k), (5, 1)))
    _same_search(ours, jargs, count, k)


def test_plain_int8_search_cutoff_tie():
    """k = 64 where the 64th and 65th scores tie between rows far apart:
    row c, ranked past 65th, becomes a copy of the 64th row a (its int8
    row and scale), so the two score bit-equal at the cutoff; the lower
    index takes the 64th place, as in facekit's XLA and Pallas int8
    searches. The card's search must keep this order where it prunes at
    the cutoff."""
    jargs, targs = _search_data(41, grid_queries=True)
    order = cosine_topk_int8_reference(*targs, N, N)[1][0].numpy()
    a = int(order[63])
    c = next(int(r) for r in order[65:] if abs(int(r) - a) >= 300)
    gq, gs = (np.asarray(t).copy() for t in jargs[:2])
    gq[c], gs[c] = gq[a], gs[a]
    jargs = (jnp.asarray(gq), jnp.asarray(gs), jargs[2])
    targs = (torch.tensor(gq), torch.tensor(gs), targs[2])
    for k in (64, 65):
        ours = cosine_topk_int8_reference(*targs, N, k)
        _same_search(ours, jargs, N, k)
    np.testing.assert_array_equal(ours[1][0, 63:65].numpy(),
                                  [min(a, c), max(a, c)])
    assert ours[0][0, 63] == ours[0][0, 64]
