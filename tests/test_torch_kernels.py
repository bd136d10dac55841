"""facekit_torch's hand-written kernels against their plain versions.

This file imports neither JAX nor facekit, so it also runs where only
PyTorch is installed. The tests marked ``cuda`` need an NVIDIA GPU and skip
without one; on a card run them with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from facekit_torch.models.arcface import IRBlock
from facekit_torch.ops.conv_s8 import _conv_s8_cuda, conv_s8, conv_s8_reference
from facekit_torch.ops.ir_block import (_conv3x3, _ir_block_cuda, _plain_u,
                                        block_operands, ir_block,
                                        ir_block_reference, u_rounding_bound)
from facekit_torch.ops.similarity import (_cosine_topk_cuda,
                                          _cosine_topk_int8_cuda, cosine_topk,
                                          cosine_topk_int8,
                                          cosine_topk_int8_reference,
                                          cosine_topk_reference, pad_width,
                                          quantize_rows_int8)

N = 1000


def _data(seed, n=N, b=5, ties=False):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, 512))
    g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    q = rng.normal(size=(b, 512))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    if ties:
        # rows 600.. duplicate rows 0..; queries are those rows, so every
        # query has two equal top scores and the lower index must win
        g[600:600 + b] = g[:b]
        q = g[:b].copy()
    return g, q


def test_wrapper_runs_plain_version_on_cpu():
    g, q = _data(3)
    gt, qt = torch.tensor(g), torch.tensor(q)
    before = cosine_topk.launches
    for a, b in zip(cosine_topk(gt, qt, 900, 3),
                    cosine_topk_reference(gt, qt, 900, 3)):
        assert torch.equal(a, b)
    assert cosine_topk.launches == before      # no kernel ran


def test_kernel_path_refuses_cpu_tensors():
    g, q = _data(3)
    with pytest.raises(ValueError, match="CUDA"):
        _cosine_topk_cuda(torch.tensor(g), torch.tensor(q), N, 1)


def _int8_gallery(g):
    gq, gs = quantize_rows_int8(torch.tensor(g))
    return gq, gs


def test_int8_wrapper_runs_plain_version_on_cpu():
    g, q = _data(4)
    gq, gs = _int8_gallery(g)
    before = cosine_topk_int8.launches
    for a, b in zip(cosine_topk_int8(gq, gs, torch.tensor(q), 900, 3),
                    cosine_topk_int8_reference(gq, gs, torch.tensor(q), 900,
                                               3)):
        assert torch.equal(a, b)
    assert cosine_topk_int8.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _cosine_topk_int8_cuda(gq, gs, torch.tensor(q), N, 1)


def _s8(rng, shape):
    return torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)


def test_conv_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    x, w = _s8(rng, (2, 9, 9, 8)), _s8(rng, (64, 3, 3, 8))
    before = conv_s8.launches
    got = conv_s8(x, w, stride=2, padding=1)
    assert got.dtype == torch.int32 and got.shape == (2, 5, 5, 64)
    assert torch.equal(got, conv_s8_reference(x, w, 2, 1))
    assert conv_s8.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _conv_s8_cuda(x, w, 2, 1)


def _ir_operands(rng, c, dtype=torch.float32):
    """(w1, w2, par) of a random IR block: weights (C, 3, 3, C) in
    ``dtype``, par (5, C) f32 = s1, b1, alpha, s2, b2."""
    a = np.sqrt(6.0 / (9 * c))
    w1, w2 = (torch.tensor(rng.uniform(-a, a, (c, 3, 3, c)),
                           dtype=torch.float32).to(dtype) for _ in range(2))
    par = torch.tensor(np.stack([rng.uniform(0.5, 1.5, c),
                                 rng.uniform(-0.2, 0.2, c),
                                 rng.uniform(0.1, 0.4, c),
                                 rng.uniform(0.5, 1.5, c),
                                 rng.uniform(-0.2, 0.2, c)]),
                       dtype=torch.float32)
    return w1, w2, par


def test_ir_block_wrapper_runs_plain_version_on_cpu():
    """An IR-50 identity block on a CPU tensor: ``ir_block`` is the plain
    version on the block's operands, bit for bit, and launches nothing."""
    rng = np.random.default_rng(6)
    blk = IRBlock(64, 64, 1, se=False).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.tensor(rng.uniform(0.1, 0.3, p.shape)))
    x = torch.tensor(rng.normal(size=(2, 7, 5, 64)), dtype=torch.float32)
    before = ir_block.launches
    with torch.no_grad():
        got = ir_block(x, blk)
    assert torch.equal(got, ir_block_reference(
        x, *block_operands(blk, torch.float32)))
    assert ir_block.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        _ir_block_cuda(x, *block_operands(blk, torch.float32))


def test_u_rounding_bound_is_one_step_of_u():
    """With u > 0 and w2 >= 0, moving every element of u one bf16 step up
    moves m2 * s2 by exactly ``u_rounding_bound``."""
    rng = np.random.default_rng(8)
    w1, w2, par = _ir_operands(rng, 64, torch.bfloat16)
    w1, w2, par = w1.abs(), w2.abs(), par.abs()
    x = torch.tensor(rng.uniform(0.1, 1.0, (1, 5, 6, 64)),
                     dtype=torch.float32).to(torch.bfloat16)
    u = _plain_u(x, w1, par)
    assert (u > 0).all()
    up = (u.view(torch.int16) + 1).view(torch.bfloat16)
    moved = (_conv3x3(up.double(), w2.double())
             - _conv3x3(u.double(), w2.double())) * par[3].double()
    np.testing.assert_allclose(u_rounding_bound(x, w1, w2, par).numpy(),
                               moved.numpy(), rtol=1e-5)


# -- the CUDA kernels (skipped without a card) --------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the search kernel is CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,count", [(1, 1, N), (2, 3, 777), (3, 5, N),
                                       (8, 3, 777), (256, 64, N), (5, 8, 3),
                                       (9, 1, N), (16, 5, 777), (32, 1, N),
                                       (64, 64, 777), (200, 64, N), (33, 8, 3),
                                       (40, 64, 777), (65, 8, N), (1, 64, N),
                                       (8, 64, 777), (4, 64, N)])
def test_kernel_matches_plain(cuda_device, dtype, b, k, count):
    """Batches above 8 run the tensor-core pass 1 (f32: 32 queries a CTA,
    so 33 and 40 fill a second tile in part and 65 a third; bf16: 64).
    Batches up to 8 at k = 64 run the batched selection, and pass 2 takes
    its bound from the first 16 entries of each of the 4 chunks."""
    g, q = _data(b + k, b=b)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gt = torch.tensor(g).to(cuda_device, td)
    qt = torch.tensor(q).to(cuda_device, td)
    before = cosine_topk.launches
    vals, idx = cosine_topk(gt, qt, count, k)
    ref_v, ref_i = cosine_topk_reference(gt, qt, count, k)
    torch.cuda.synchronize()
    assert cosine_topk.launches == before + 1
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_i.cpu().numpy())
    np.testing.assert_allclose(vals.cpu().numpy(), ref_v.cpu().numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 5, 16, 33])
def test_kernel_ties_and_checks(cuda_device, b):
    """Rows 600+j duplicate rows j; both float dtypes, so that batches above
    8 also meet the bf16 tensor-core kernel, where rows j and 600+j sit at
    different positions of their 128-row tiles and in different chunks."""
    g, q = _data(7, b=b, ties=True)
    for td in (torch.float32, torch.bfloat16):
        gt = torch.tensor(g, device=cuda_device).to(td)
        qt = torch.tensor(q, device=cuda_device).to(td)
        vals, idx = cosine_topk(gt, qt, N, 2)
        np.testing.assert_array_equal(
            idx.cpu().numpy(), np.stack([np.arange(b), 600 + np.arange(b)], 1))
        assert torch.equal(vals[:, 0], vals[:, 1])
    gt, qt = torch.tensor(g, device=cuda_device), torch.tensor(q, device=cuda_device)
    with pytest.raises(ValueError):
        cosine_topk(gt, qt, N, 65)
    with pytest.raises(TypeError):
        cosine_topk(gt, qt.to(torch.bfloat16), N, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 33])
def test_f32_tensor_core_ties_across_chunks(cuda_device, b):
    """f32 at B > 8 (3xTF32): query j is row lo_j, duplicated at row
    hi_j in another chunk, at another place of its 128-row tile and in
    another warp's 32 rows; the two scores must be bit-equal and the lower
    index must come first."""
    n = 16384
    g, _ = _data(11, n=n, b=1)
    lo = np.arange(b) * 157 + 3
    hi = lo + n // 2 + 45
    g[hi] = g[lo]
    gt = torch.tensor(g, device=cuda_device)
    before = cosine_topk.launches
    vals, idx = cosine_topk(gt, gt[lo].contiguous(), n, 2)
    torch.cuda.synchronize()
    assert cosine_topk.launches == before + 1
    np.testing.assert_array_equal(idx.cpu().numpy(), np.stack([lo, hi], 1))
    assert torch.equal(vals[:, 0], vals[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,count", [(1, 1, N), (2, 3, 777), (3, 5, N),
                                       (8, 3, 777), (64, 1, N),
                                       (256, 64, N), (5, 8, 3), (9, 1, N),
                                       (16, 5, 777), (33, 8, 3),
                                       (64, 64, 777), (200, 64, N),
                                       (1, 64, N), (8, 64, 777), (4, 64, N)])
def test_int8_kernel_matches_plain_bit_for_bit(cuda_device, b, k, count):
    g, q = _data(b + k + 1, b=b)
    gq, gs = (t.to(cuda_device) for t in _int8_gallery(g))
    qt = torch.tensor(q, device=cuda_device)
    before = cosine_topk_int8.launches
    vals, idx = cosine_topk_int8(gq, gs, qt, count, k)
    ref_v, ref_i = cosine_topk_int8_reference(gq, gs, qt, count, k)
    torch.cuda.synchronize()
    assert cosine_topk_int8.launches == before + 1
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_i.cpu().numpy())
    np.testing.assert_array_equal(vals.cpu().numpy(), ref_v.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 5, 16, 33])
def test_int8_kernel_ties_and_checks(cuda_device, b):
    """Rows 600+j duplicate rows j; batches above 8 meet the tensor-core
    kernel, where rows j and 600+j sit at different positions of their
    128-row tiles and in different chunks."""
    g, q = _data(7, b=b, ties=True)
    gq, gs = (t.to(cuda_device) for t in _int8_gallery(g))
    vals, idx = cosine_topk_int8(gq, gs, torch.tensor(q, device=cuda_device),
                                 N, 2)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  np.stack([np.arange(b), 600 + np.arange(b)], 1))
    assert torch.equal(vals[:, 0], vals[:, 1])
    with pytest.raises(ValueError):
        cosine_topk_int8(gq, gs, torch.tensor(q, device=cuda_device), N, 65)
    with pytest.raises(TypeError):
        cosine_topk_int8(gq, gs, torch.tensor(q, device=cuda_device)
                         .to(torch.bfloat16), N, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("k", [1, 64])
def test_kernels_at_narrow_widths(cuda_device, d, b, k):
    """Both searches at D < 512: a gallery of that width (the wrapper pads
    a copy) and a 512-wide padded one with narrow queries (what
    ``GalleryStore`` holds on the card) against the plain version at D.
    Indices equal; int8 scores bit for bit, float scores within 1e-5."""
    rng = np.random.default_rng(d + b + k)
    g = rng.normal(size=(N, d))
    g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    q = rng.normal(size=(b, d))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    gt, qt = (torch.tensor(a, device=cuda_device) for a in (g, q))
    for td in (torch.float32, torch.bfloat16):
        gd, qd = gt.to(td), qt.to(td)
        ref_v, ref_i = cosine_topk_reference(gd, qd, 777, k)
        for gallery in (gd, pad_width(gd)):
            before = cosine_topk.launches
            vals, idx = cosine_topk(gallery, qd, 777, k)
            torch.cuda.synchronize()
            assert cosine_topk.launches == before + 1
            np.testing.assert_array_equal(idx.cpu().numpy(),
                                          ref_i.cpu().numpy())
            np.testing.assert_allclose(vals.cpu().numpy(),
                                       ref_v.cpu().numpy(), rtol=0, atol=1e-5)
    gq, gs = quantize_rows_int8(gt)
    ref_v, ref_i = cosine_topk_int8_reference(gq, gs, qt, 777, k)
    for gallery in (gq, pad_width(gq)):
        before = cosine_topk_int8.launches
        vals, idx = cosine_topk_int8(gallery, gs, qt, 777, k)
        torch.cuda.synchronize()
        assert cosine_topk_int8.launches == before + 1
        np.testing.assert_array_equal(idx.cpu().numpy(), ref_i.cpu().numpy())
        np.testing.assert_array_equal(vals.cpu().numpy(), ref_v.cpu().numpy())


# a gallery the B <= 8 plan cuts into 256 chunks of 256 rows: at k = 64
# each warp sees 32 rows, fewer than k, and pass 2 meets 16,384 partials
N_CHUNKY = 65536


def _search(kind, g, q, count, k, device):
    """The kernel's and the plain version's (vals, idx) for a ``kind``
    search (float32, bfloat16 or int8) of f32 rows ``g`` and queries ``q``;
    checks that the kernel launched once."""
    fn = cosine_topk_int8 if kind == "int8" else cosine_topk
    if kind == "int8":
        args = (*(t.to(device) for t in _int8_gallery(g)),
                torch.tensor(q, device=device))
        plain = cosine_topk_int8_reference
    else:
        td = getattr(torch, kind)
        args = (torch.tensor(g, device=device).to(td),
                torch.tensor(q, device=device).to(td))
        plain = cosine_topk_reference
    before = fn.launches
    got = fn(*args, count, k)
    ref = plain(*args, count, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 8])
def test_kernel_k64_many_chunks(cuda_device, kind, b):
    """k = 64 over 256 chunks: the batched selection with lists that see
    fewer rows than k, and pass 2's bound over 256 first entries. int8
    scores bit for bit; float scores within 1e-5."""
    g, q = _data(b + 64, n=N_CHUNKY, b=b)
    (vals, idx), (ref_v, ref_i) = _search(kind, g, q, N_CHUNKY - 37, 64,
                                          cuda_device)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_i.cpu().numpy())
    if kind == "int8":
        np.testing.assert_array_equal(vals.cpu().numpy(), ref_v.cpu().numpy())
    else:
        np.testing.assert_allclose(vals.cpu().numpy(), ref_v.cpu().numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 8])
def test_kernel_cutoff_ties(cuda_device, kind, b):
    """Query j's row has 70 copies, one every 936 rows, so each lies in
    its own chunk; the top 64 must be the 64 lowest indices of the copies
    with bit-equal scores: the 64th and the next 6 tie, and pass 1's and
    pass 2's pruning drop only scores strictly below their bounds."""
    g, _ = _data(19, n=N_CHUNKY, b=1)
    pos = (np.arange(70)[None, :] * (N_CHUNKY // 70)
           + np.arange(b)[:, None] * 97 + 13)
    g[pos] = g[pos[:, :1]]
    (vals, idx), (ref_v, ref_i) = _search(kind, g, g[pos[:, 0]], N_CHUNKY,
                                          64, cuda_device)
    np.testing.assert_array_equal(idx.cpu().numpy(), pos[:, :64])
    assert torch.equal(vals, vals[:, :1].expand(-1, 64))
    if kind == "int8":
        assert torch.equal(vals, ref_v) and torch.equal(idx, ref_i)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_kernel_equal_rows_past_pass2_room(cuda_device, kind):
    """Every row equal: all 16,384 partials of each query tie at the
    bound, more than pass 2 holds in shared memory, so it scans them all;
    the top 64 are rows 0..63 with bit-equal scores."""
    g, q = _data(23, n=N_CHUNKY, b=2)
    g[:] = g[0]
    (vals, idx), _ = _search(kind, g, q, N_CHUNKY, 64, cuda_device)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  np.tile(np.arange(64), (2, 1)))
    assert torch.equal(vals, vals[:, :1].expand(-1, 64))


# (N, H, W, C, O, kernel, stride, padding): every stride, padding, kernel
# size and C_in in {3, 64}, odd sizes so the pixel tiles have ragged ends
CONV_CASES = [(2, 13, 11, 3, 64, 3, 1, 1), (2, 13, 11, 64, 64, 3, 1, 1),
              (2, 13, 11, 64, 128, 3, 2, 1), (2, 13, 11, 3, 64, 3, 2, 1),
              (2, 13, 11, 64, 64, 3, 1, 0), (3, 9, 9, 64, 128, 1, 2, 0),
              (3, 9, 9, 3, 64, 1, 1, 0), (1, 8, 8, 16, 64, 1, 1, 1),
              (2, 7, 7, 512, 64, 3, 1, 1), (1, 14, 14, 4, 192, 3, 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,ks,stride,pad", CONV_CASES)
def test_conv_kernel_matches_plain_bit_for_bit(cuda_device, n, h, w, c, o,
                                                ks, stride, pad):
    rng = np.random.default_rng(n * h + c + o + ks + stride + pad)
    x = _s8(rng, (n, h, w, c)).to(cuda_device)
    wt = _s8(rng, (o, ks, ks, c)).to(cuda_device)
    before = conv_s8.launches
    got = conv_s8(x, wt, stride, pad)
    ref = conv_s8_reference(x, wt, stride, pad)
    torch.cuda.synchronize()
    assert conv_s8.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.int32
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_conv_kernel_refuses_what_it_does_not_take(cuda_device):
    """What no route takes: O no multiple of 8, a 5x5 kernel, groups
    other than 1 and C (or a depthwise 1x1), float input."""
    x = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_s8(x, torch.zeros((12, 3, 3, 64), dtype=torch.int8,
                               device=cuda_device))
    with pytest.raises(ValueError, match="1x1 or 3x3"):
        conv_s8(x, torch.zeros((64, 5, 5, 64), dtype=torch.int8,
                               device=cuda_device))
    with pytest.raises(ValueError, match="depthwise 3x3"):
        conv_s8(x, torch.zeros((64, 3, 3, 2), dtype=torch.int8,
                               device=cuda_device), groups=32)
    with pytest.raises(ValueError, match="depthwise 3x3"):
        conv_s8(x, torch.zeros((64, 1, 1, 1), dtype=torch.int8,
                               device=cuda_device), groups=64)
    with pytest.raises(TypeError):
        conv_s8(x.float(), torch.zeros((64, 3, 3, 64), device=cuda_device))


# (N, H, W, C, O, kernel, stride, padding) of the tensor-core route and
# its edges: ragged pixel tiles, C in {16, 64, 512} (16: a 3x3 K of 144
# bytes, one full stage and one mostly past K), O in {64, 128, 192, 512}
# (192: three 64-channel tiles), the split-K route (batch 1 at 7x7x512:
# a cluster of 8 splits of five stages, the last of one; 4x4 pixels: one
# tile, 5 splits, the last of one stage), tiles without split (20,000
# pixels: 157 tiles), and C = 4 on the dp4a route with O = 128
CONV_MMA_CASES = [(3, 9, 7, 16, 64, 3, 1, 1), (2, 11, 13, 64, 192, 3, 2, 1),
                  (1, 7, 7, 512, 512, 3, 1, 1), (2, 14, 14, 256, 128, 1, 2, 0),
                  (1, 4, 4, 128, 128, 3, 1, 1), (2, 100, 100, 64, 64, 3, 1, 1),
                  (1, 9, 9, 16, 512, 1, 1, 1), (1, 5, 5, 4, 128, 3, 1, 1),
                  (2, 15, 9, 64, 128, 3, 2, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,ks,stride,pad", CONV_MMA_CASES)
def test_conv_tensor_core_route_bit_for_bit(cuda_device, n, h, w, c, o, ks,
                                            stride, pad):
    rng = np.random.default_rng(7 * n + h + w + c + o + ks + stride + pad)
    x = _s8(rng, (n, h, w, c)).to(cuda_device)
    wt = _s8(rng, (o, ks, ks, c)).to(cuda_device)
    before = conv_s8.launches
    got = conv_s8(x, wt, stride, pad)
    ref = conv_s8_reference(x, wt, stride, pad)
    torch.cuda.synchronize()
    assert conv_s8.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("n", [1, 8])
def test_conv_extreme_sums(cuda_device, sign, n):
    """Every input 127 and every weight +-127 at C = 512, 3x3: each inner
    output sums 4,608 products of 127**2 (74,322,432 in magnitude), edges
    fewer; at batches 1 and 8 K splits over a cluster of 8 CTAs."""
    x = torch.full((n, 7, 7, 512), 127, dtype=torch.int8, device=cuda_device)
    wt = torch.full((512, 3, 3, 512), sign * 127, dtype=torch.int8,
                    device=cuda_device)
    got = conv_s8(x, wt, 1, 1)
    ref = conv_s8_reference(x, wt, 1, 1)
    torch.cuda.synchronize()
    assert int(got[0, 3, 3, 0]) == sign * 127 ** 2 * 4608
    assert torch.equal(got, ref)


# (N, H, W, C, O, kernel, stride, padding, splits on 132 SMs): K split
# into clusters of 2, 3, 4, 5, 6 and 8 CTAs (no power-of-two C makes the
# 13 or 14 stages of a cluster of 7 at one tile), over ragged
# pixel tiles (5x5 pixels of 6 images: two tiles, the second of 22
# pixels) and 64- and 128-channel tiles
CONV_CLUSTER_CASES = [(6, 5, 5, 32, 192, 3, 1, 1, 2),
                      (6, 5, 5, 64, 128, 3, 1, 1, 3),
                      (1, 5, 5, 1024, 64, 1, 1, 0, 4),
                      (6, 5, 5, 128, 192, 3, 1, 1, 5),
                      (1, 5, 5, 256, 128, 3, 1, 1, 6),
                      (6, 5, 5, 512, 128, 3, 1, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,ks,stride,pad,splits",
                         CONV_CLUSTER_CASES)
def test_conv_split_clusters_bit_for_bit(cuda_device, n, h, w, c, o, ks,
                                         stride, pad, splits):
    """Each split of a cluster sums a share of the tile's rows over the
    cluster's partial tiles: bit for bit at every cluster size."""
    from facekit_torch.ops.conv_s8 import _launch_plan, _sms
    oh = (h + 2 * pad - ks) // stride + 1
    plan = _launch_plan(n, oh, oh, o, c, ks, _sms(cuda_device.index or 0))
    if _sms(cuda_device.index or 0) == 132:
        assert plan.splits == splits
    rng = np.random.default_rng(n + h + c + o + ks + splits)
    x = _s8(rng, (n, h, w, c)).to(cuda_device)
    wt = _s8(rng, (o, ks, ks, c)).to(cuda_device)
    got = conv_s8(x, wt, stride, pad)
    ref = conv_s8_reference(x, wt, stride, pad)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _ir50_conv_shapes(n):
    """(N, H, W, C, O, kernel, stride, padding) of the int8 IR-50's 16 conv
    shapes at batch n."""
    from facekit_torch.models.arcface import block_specs
    shapes, h = [(n, 112, 112, 3, 64, 3, 1, 1)], 112
    for in_c, depth, stride in block_specs("ir_50"):
        shapes += [(n, h, h, in_c, depth, 3, 1, 1),
                   (n, h, h, depth, depth, 3, stride, 1)]
        if in_c != depth:
            shapes.append((n, h, h, in_c, depth, 1, stride, 0))
        h = (h - 1) // stride + 1
    return list(dict.fromkeys(shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _ir50_conv_shapes(2),
                         ids=lambda s: "h{1}c{3}o{4}k{5}s{6}".format(*s))
def test_conv_ir50_shapes_at_batch_2(cuda_device, shape):
    n, h, w, c, o, ks, stride, pad = shape
    rng = np.random.default_rng(h + c + o + ks + stride)
    x = _s8(rng, (n, h, w, c)).to(cuda_device)
    wt = _s8(rng, (o, ks, ks, c)).to(cuda_device)
    got = conv_s8(x, wt, stride, pad)
    torch.cuda.synchronize()
    assert torch.equal(got, conv_s8_reference(x, wt, stride, pad))


DET_HW = (288, 320)          # the detectors' input at configs/default.json


def _detector_conv_shapes(n, family):
    """(N, H, W, C, O, kernel, stride, padding, groups) of every int8 site
    of one int8 detector forward at DET_HW and batch n (RetinaFace's 47,
    slim's 25, RFB's 23; tests/test_torch_conv_plan.py holds this list to
    the sites a forward of the port's modules runs)."""
    from facekit_torch.models.lightdet import DW_CHAIN, RFB_INDEX
    from facekit_torch.models.retinaface import (_FPN_IN, _OUT_CH, _STAGE1,
                                                 _STAGE2, _STAGE3)
    hw = list(DET_HW)
    out = []

    def site(c, o, k, stride, pad, groups=1, at=None):
        h, w = at or hw
        out.append((n, h, w, c, o, k, stride, pad, groups))
        if at is None:
            hw[:] = [(d + 2 * pad - k) // stride + 1 for d in hw]

    def dw_unit(ci, co, stride):
        site(ci, ci, 3, stride, 1, ci)
        site(ci, co, 1, 1, 0)

    if family == "mobilenet0.25":
        site(3, 8, 3, 2, 1)
        levels = []
        for stage in (_STAGE1, _STAGE2, _STAGE3):
            for ci, co, stride in stage:
                dw_unit(ci, co, stride)
            levels.append(tuple(hw))
        for c, at in zip(_FPN_IN, levels):
            site(c, _OUT_CH, 1, 1, 0, at=at)
        site(_OUT_CH, _OUT_CH, 3, 1, 1, at=levels[1])          # merge2
        site(_OUT_CH, _OUT_CH, 3, 1, 1, at=levels[0])          # merge1
        for at in levels:                                      # SSH
            site(_OUT_CH, _OUT_CH // 2, 3, 1, 1, at=at)
            site(_OUT_CH, _OUT_CH // 4, 3, 1, 1, at=at)
            for _ in range(3):
                site(_OUT_CH // 4, _OUT_CH // 4, 3, 1, 1, at=at)
        return out
    site(3, 16, 3, 2, 1)
    for i, (ci, co, stride) in enumerate(DW_CHAIN):
        if not (family == "rfb" and i == RFB_INDEX):
            dw_unit(ci, co, stride)
    return out


DET_CONV_CASES = list(dict.fromkeys(
    shape for n in (1, 8) for family in ("mobilenet0.25", "slim", "rfb")
    for shape in _detector_conv_shapes(n, family)))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", DET_CONV_CASES,
    ids=lambda s: "n{0}h{1}w{2}c{3}o{4}k{5}s{6}g{8}".format(*s))
def test_conv_detector_shapes_bit_for_bit(cuda_device, shape):
    """Every distinct int8 site of the three detectors at 288x320, at
    batches 1 and 8: the depthwise route (C from 8 to 256, strides 1 and
    2), the 8-, 16- and 32-channel outputs on both dense routes, and the
    9x10 and 5x5 maps whose pixels fill a part of one 128-pixel tile."""
    n, h, w, c, o, ks, stride, pad, groups = shape
    rng = np.random.default_rng(n + h + w + c + o + ks + stride + groups)
    x = _s8(rng, (n, h, w, c)).to(cuda_device)
    wt = _s8(rng, (o, ks, ks, c // groups)).to(cuda_device)
    before = conv_s8.launches
    got = conv_s8(x, wt, stride, pad, groups)
    ref = conv_s8_reference(x, wt, stride, pad, groups)
    torch.cuda.synchronize()
    assert conv_s8.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)


# (N, H, W, C, O, kernel, stride, padding, groups): odd sizes, so every
# route's pixel tiles end ragged; C = 24 and 8 take the depthwise route's
# 4-channel runs; O = 24 and 40 end a 64-channel tile part way, on the
# dp4a (C = 8) and the tensor-core route (C = 16, 64; split K at batch 1);
# extreme sums on the depthwise route
CONV_NARROW_CASES = [(2, 13, 11, 24, 24, 3, 1, 1, 24),
                     (3, 9, 7, 8, 8, 3, 2, 1, 8),
                     (1, 15, 17, 256, 256, 3, 2, 1, 256),
                     (2, 13, 11, 32, 32, 3, 1, 0, 32),
                     (2, 13, 11, 8, 24, 1, 1, 0, 1),
                     (2, 13, 11, 4, 40, 3, 2, 1, 1),
                     (3, 9, 7, 16, 40, 3, 1, 1, 1),
                     (1, 7, 7, 64, 24, 3, 1, 1, 1),
                     (2, 13, 11, 64, 200, 1, 2, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,ks,stride,pad,groups", CONV_NARROW_CASES)
def test_conv_narrow_and_depthwise_bit_for_bit(cuda_device, n, h, w, c, o,
                                               ks, stride, pad, groups):
    rng = np.random.default_rng(3 * n + h + w + c + o + ks + groups)
    x = _s8(rng, (n, h, w, c)).to(cuda_device)
    wt = _s8(rng, (o, ks, ks, c // groups)).to(cuda_device)
    got = conv_s8(x, wt, stride, pad, groups)
    ref = conv_s8_reference(x, wt, stride, pad, groups)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if groups > 1:
        # every input -127 and every weight 127: each inner sum is 9 of
        # the largest products
        full = conv_s8(torch.full_like(x, -127), torch.full_like(wt, 127),
                       stride, pad, groups)
        torch.cuda.synchronize()
        assert int(full.min()) == -9 * 127 ** 2
        assert torch.equal(full, conv_s8_reference(
            torch.full_like(x, -127), torch.full_like(wt, 127), stride, pad,
            groups))


@pytest.mark.cuda
def test_conv_refuses_overflowing_k(cuda_device):
    """K = 3 * 3 * 16,384 could overflow the int32 sums: refused."""
    x = torch.zeros((1, 3, 3, 16384), dtype=torch.int8, device=cuda_device)
    wt = torch.zeros((64, 3, 3, 16384), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="overflow"):
        conv_s8(x, wt, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [257, 512])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_search_past_256_queries(cuda_device, kind, b, k):
    """Both searches at more queries than 256 (5 and 8 query tiles of 64,
    9 and 16 of 32 in f32), in one launch, equal to the plain versions.
    Every value is a multiple of 1/16 in [-1, 1], exact in bf16 and in a
    TF32 hi part, so every float score is an exact sum in any order: the
    scores are bit-equal and the many equal ones must come back lowest
    index first, as the plain version's stable sort gives them."""
    rng = np.random.default_rng(b + k)
    g = (rng.integers(-16, 17, (N, 512)) / 16).astype(np.float32)
    q = (rng.integers(-16, 17, (b, 512)) / 16).astype(np.float32)
    (vals, idx), (ref_v, ref_i) = _search(kind, g, q, N - 37, k, cuda_device)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_i.cpu().numpy())
    np.testing.assert_array_equal(vals.cpu().numpy(), ref_v.cpu().numpy())


# (N, H, W, C): the four IR-50 identity-block shapes, ragged bands (H not
# a multiple of the kernel's 4-row band, odd W), the forward of WS
# /inference at bucket 8 (8 frames x 4 faces), and an 8-CTA cluster on an
# image whose band pixels are no multiple of the 16-row tensor-core tile
IR_BLOCK_CASES = [(2, 56, 56, 64), (2, 28, 28, 128), (1, 14, 14, 256),
                  (1, 7, 7, 512), (3, 9, 13, 64), (1, 5, 3, 128),
                  (32, 14, 14, 256), (1, 3, 5, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c", IR_BLOCK_CASES)
def test_ir_block_kernel_matches_plain(cuda_device, n, h, w, c, dtype):
    """f32 within 1e-4 (sums over 9*C terms in another order than
    cuDNN's). bf16: u and the output are each rounded to bf16 once, from
    f32 sums taken in another order, so all but 1e-5 of the outputs lie
    within two bf16 steps of the plain version's (2**-6 of the magnitude,
    plus 2**-9 near 0), and every one within that plus the spread one step
    of u in each input of conv2 can cause (``u_rounding_bound``)."""
    torch.backends.cudnn.allow_tf32 = False
    td = getattr(torch, dtype)
    rng = np.random.default_rng(n * h * w + c)
    w1, w2, par = (t.to(cuda_device) for t in _ir_operands(rng, c, td))
    x = torch.tensor(rng.normal(size=(n, h, w, c)), dtype=torch.float32,
                     device=cuda_device).to(td)
    before = ir_block.launches
    got = _ir_block_cuda(x, w1, w2, par)
    ref = ir_block_reference(x, w1, w2, par)
    torch.cuda.synchronize()
    assert ir_block.launches == before + 1
    assert got.shape == ref.shape and got.dtype == td
    err = (got.float() - ref.float()).abs()
    if dtype == "float32":
        assert err.max() <= 1e-4, err.max()
    else:
        steps = 2.0 ** -6 * ref.float().abs() + 2.0 ** -9
        assert (err > steps).float().mean() <= 1e-5, err.max()
        assert (err <= steps + u_rounding_bound(x, w1, w2, par)).all()


@pytest.mark.cuda
def test_ir_block_kernel_refuses_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(7)
    w1, w2, par = (t.to(cuda_device) for t in _ir_operands(rng, 32))
    with pytest.raises(ValueError, match="multiple of 64"):
        _ir_block_cuda(torch.zeros((1, 7, 7, 32), device=cuda_device), w1,
                       w2, par)
    w1, w2, par = (t.to(cuda_device) for t in _ir_operands(rng, 64))
    x = torch.zeros((1, 7, 7, 64), device=cuda_device)
    with pytest.raises(TypeError):
        _ir_block_cuda(x.half(), w1.half(), w2.half(), par)
    with pytest.raises(TypeError):
        _ir_block_cuda(x, w1.to(torch.bfloat16), w2, par)
    with pytest.raises(ValueError, match="f32 expected"):
        _ir_block_cuda(x, w1, w2, par[:4])


# -- the registered ops and the exported engines on the card ------------------

def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _cuda_op_cases(device):
    """(op, args, direct wrapper, plain check, launch counter) per kernel,
    at served shapes: the bf16 and int8 searches at B = 8, the s8 conv at
    the IR-50 28x28x128 site of batch 8, the bf16 block at 56x56x64."""
    rng = np.random.default_rng(21)
    g, q = _data(21, b=8)
    gb = torch.tensor(g).to(device, torch.bfloat16)
    qb = torch.tensor(q).to(device, torch.bfloat16)
    gq, gs = quantize_rows_int8(torch.tensor(g, device=device))
    qf = torch.tensor(q, device=device)
    x8, w8 = _s8(rng, (8, 28, 28, 128)), _s8(rng, (128, 3, 3, 128))
    w1, w2, par = _ir_operands(rng, 64, torch.bfloat16)
    x = torch.tensor(rng.normal(size=(8, 56, 56, 64)),
                     dtype=torch.float32).to(torch.bfloat16)

    def search_close(got, args):
        ref_v, ref_i = cosine_topk_reference(*args)
        assert torch.equal(got[1], ref_i)
        assert (got[0] - ref_v).abs().max() <= 1e-5

    def exact(plain):
        def check(got, args):
            for a, b in zip(_as_tuple(got), _as_tuple(plain(*args))):
                assert torch.equal(a, b)
        return check

    def block_close(got, args):
        ref = ir_block_reference(*args).float()
        err = (got.float() - ref).abs()
        steps = 2.0 ** -6 * ref.abs() + 2.0 ** -9
        assert (err > steps).float().mean() <= 1e-5
        assert (err <= steps + u_rounding_bound(*args)).all()

    ops = torch.ops.facekit_torch
    return {
        "cosine_topk": (ops.cosine_topk, (gb, qb, N, 1), _cosine_topk_cuda,
                        search_close, cosine_topk),
        "cosine_topk_int8": (ops.cosine_topk_int8, (gq, gs, qf, 777, 5),
                             _cosine_topk_int8_cuda,
                             exact(cosine_topk_int8_reference),
                             cosine_topk_int8),
        "conv_s8": (ops.conv_s8, (x8.to(device), w8.to(device), 1, 1, 1),
                    _conv_s8_cuda, exact(conv_s8_reference), conv_s8),
        "ir_block": (ops.ir_block, tuple(t.to(device)
                                         for t in (x, w1, w2, par)),
                     _ir_block_cuda, block_close, ir_block),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cosine_topk", "cosine_topk_int8",
                                  "conv_s8", "ir_block"])
def test_registered_op_launches_its_kernel(cuda_device, name):
    """On CUDA tensors each op launches its kernel once and returns what
    the direct wrapper returns, bit for bit; it holds to its plain version
    as the kernel tests above do (the conv and the int8 search bit for
    bit); its fake gives the real output's shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    torch.backends.cudnn.allow_tf32 = False
    op, args, direct, check, counter = _cuda_op_cases(cuda_device)[name]
    before = counter.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b in zip(_as_tuple(got), _as_tuple(direct(*args))):
        assert torch.equal(a, b)
    check(got, args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    for f, r in zip(_as_tuple(fake), _as_tuple(got)):
        assert f.shape == r.shape and f.dtype == r.dtype
        assert f.device == r.device


def _launch_counts():
    return {f.__name__: f.launches
            for f in (cosine_topk, cosine_topk_int8, conv_s8, ir_block)}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_recognize_engine_on_the_card_equals_eager(cuda_device, tmp_path,
                                                   int8):
    """An ir_tiny + RetinaFace recognize engine exported and loaded on
    the card equals the eager pipeline there bit for bit and launches the
    same kernels as often (int8: the 47 + 12 conv_s8 sites); it refuses
    to load on the CPU, and a CPU engine refuses to load on the card."""
    from facekit_torch.config import FaceKitConfig
    from facekit_torch.engine import (engine_states, export_embed_engine,
                                      export_recognize_engine, load_engine,
                                      save_engine)
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.weights import (random_arcface_params,
                                       random_retinaface_params)
    torch.backends.cudnn.allow_tf32 = False
    cfg = FaceKitConfig(rec_network="ir_tiny", compute_dtype="bfloat16",
                        gallery_dtype="int8" if int8 else "bfloat16",
                        rec_quantize=int8, det_quantize=int8,
                        det_inputShape=(3, 64, 64), input_frameWidth=160,
                        input_frameHeight=120, det_threshold_bbox=0.5,
                        extras={"rec_useAlignment": True})
    rp = random_arcface_params("ir_tiny", seed=4)
    dp = random_retinaface_params(seed=0)
    pipe = FacePipeline(cfg, rp, dp, device=cuda_device)
    path = str(tmp_path / "recognize.fke")
    save_engine(path, *export_recognize_engine(pipe, 2, return_crops=True))
    fn, meta = load_engine(path, "cuda")
    assert meta["device"] == "cuda"
    frames = np.random.default_rng(3).integers(0, 256, (2, 120, 160, 3),
                                               dtype=np.uint8)
    before = _launch_counts()
    with torch.inference_mode():
        got = fn(*engine_states(pipe), torch.tensor(frames,
                                                   device=cuda_device))
    torch.cuda.synchronize()
    mid = _launch_counts()
    ref = pipe.recognize_frames(frames, return_crops=True)
    torch.cuda.synchronize()
    after = _launch_counts()
    engine = {k: mid[k] - before[k] for k in mid}
    eager = {k: after[k] - mid[k] for k in mid}
    assert engine == eager
    assert engine["conv_s8"] == (47 + 12 if int8 else 0)
    assert ref.valid.any()
    for a, b in zip(got, (ref.boxes, ref.scores, ref.valid, ref.embeddings,
                          ref.crops)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    with pytest.raises(ValueError, match="device='cuda'"):
        load_engine(path, "cpu")
    cpu = FacePipeline(cfg, rp, dp, device="cpu")
    save_engine(str(tmp_path / "embed.fke"), *export_embed_engine(cpu, 1))
    with pytest.raises(ValueError, match="device='cpu'"):
        load_engine(str(tmp_path / "embed.fke"), "cuda")


@pytest.mark.cuda
def test_ir50_embed_engine_launches_ir_block(cuda_device, tmp_path):
    """The bf16 IR-50 embed engine on the card: 20 ``ir_block`` launches
    per call, as the eager forward, and the same embeddings bit for
    bit."""
    from facekit_torch.config import FaceKitConfig
    from facekit_torch.engine import (engine_states, export_embed_engine,
                                      load_engine, save_engine)
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.weights import random_arcface_params
    torch.backends.cudnn.allow_tf32 = False
    pipe = FacePipeline(FaceKitConfig(rec_network="ir_50",
                                      compute_dtype="bfloat16"),
                        random_arcface_params("ir_50", seed=1),
                        device=cuda_device)
    path = str(tmp_path / "embed.fke")
    save_engine(path, *export_embed_engine(pipe, 8))
    fn, _ = load_engine(path, "cuda")
    crops = torch.tensor(np.random.default_rng(5).integers(
        0, 256, (8, 112, 112, 3), dtype=np.uint8), device=cuda_device)
    before = ir_block.launches
    with torch.inference_mode():
        got = fn(engine_states(pipe)[1], crops)
    torch.cuda.synchronize()
    assert ir_block.launches == before + 20
    assert torch.equal(got, pipe._embed(crops))
    assert ir_block.launches == before + 40
