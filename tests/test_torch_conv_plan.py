"""The launch plan of facekit_torch's s8 conv kernel.

``conv_route`` (which kernel a channel count and ``groups`` run),
``_conv_plan`` (the tensor-core route's CTA tile and K split),
``_im2col_box`` (how that route's TMA loads read x), ``_launch_plan``
(the plan the C entry point takes, which names the dense route) and
``_band_plan`` (the row bands of the two CUDA-core routes) are pure
functions of the shapes and the card's SM count, so they are checked here
on the CPU at every conv site of the int8 IR-50 at the served batches and
at every site of the int8 detectors (whose list the kernel tests take is
held here to the sites a forward runs); the im2col box also by a model
of the loads it drives, held to the plain conv. The kernel itself is in
tests/test_torch_kernels.py. Imports neither JAX nor facekit.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from facekit_torch.models import LightDet, RetinaFace, quantize_detector
from facekit_torch.models import layers as TL
from facekit_torch.models.arcface import block_specs
from facekit_torch.ops.conv_s8 import (BAND_CTAS_PER_SM, BAND_MAX_ROWS,
                                       BAND_SMEM, CONV_BK,
                                       CONV_BM, DENSE_TILES, MAX_K,
                                       TC_MIN_RING, TC_SMEM, TC_SMEM_SPARE,
                                       MAX_SPLITS, MIN_SPLIT_STAGES,
                                       MMA_MIN_C, MMA_TILES, _NO_PLAN,
                                       _band_plan, _band_smem, _box_arg,
                                       _cluster_ctas, _conv_plan,
                                       _im2col_box, _launch_plan, _tile_n,
                                       conv_route, conv_s8_reference)
from test_torch_kernels import DET_HW, _detector_conv_shapes

SMS = 132                      # an H100 SXM
BATCHES = (1, 8, 64)           # the throughput config's /recognize buckets


def _ir50_sites():
    """(H, C, O, KS, stride, pad) of the int8 IR-50's conv sites, once per
    shape: the stem, each block's conv1 and conv2, and the 1x1 shortcuts."""
    shapes, h = [(112, 3, 64, 3, 1, 1)], 112
    for in_c, depth, stride in block_specs("ir_50"):
        shapes += [(h, in_c, depth, 3, 1, 1), (h, depth, depth, 3, stride, 1)]
        if in_c != depth:
            shapes.append((h, in_c, depth, 1, stride, 0))
        h = (h - 1) // stride + 1
    return list(dict.fromkeys(shapes))


SITES = _ir50_sites()


def test_ir50_has_sixteen_conv_shapes():
    assert len(SITES) == 16
    assert [s for s in SITES if conv_route(s[1]) == "dp4a"] == [SITES[0]]


def _split_shares(stages, splits):
    """The stages each split takes, as the kernel shares them: split y
    takes stages*y // splits .. stages*(y+1) // splits - 1."""
    return [stages * (y + 1) // splits - stages * y // splits
            for y in range(splits)]


def _walk(p):
    """The (m tile, n tile) each CTA of an unsplit plan computes, as the
    kernel walks them: CTA i takes tiles i, i + ctas, ..., the n tiles
    of a run of pixels next to each other."""
    return [divmod(t, p.n_tiles) for cta in range(p.ctas)
            for t in range(cta, p.m_tiles * p.n_tiles, p.ctas)]


def _tc_smem(bn, resident_bytes):
    """A tensor-core CTA's shared memory, as ``TcConv::smem`` lays it out:
    1 KB of alignment, the ring (stages of pixels, and of weights unless
    they are resident: at most 8, as many as fit), the resident weights,
    the barriers. Returns (bytes, stages in the ring)."""
    stage = CONV_BM * CONV_BK + (0 if resident_bytes else bn * CONV_BK)
    nst = min(8, (TC_SMEM - TC_SMEM_SPARE - resident_bytes) // stage)
    return 1024 + nst * stage + resident_bytes + 16 * 8 + 16, nst


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("site", SITES[1:],
                         ids=lambda s: "h{}c{}o{}k{}s{}".format(*s[:5]))
def test_conv_plan_covers_each_site(site, batch):
    """Tiles cover the pixels and channels at a wgmma width; the splits
    cover K in whole stages, each split at least MIN_SPLIT_STAGES, in 1,
    2, 4 or 8 CTAs a cluster, one CTA a tile and split; fewer tiles than
    SMs take the most splits whose clusters all run at once. Unsplit,
    persistent CTAs (one an SM at most) walk every tile once, and keep
    the weights resident where O is one tile and they leave room for
    TC_MIN_RING stages of pixels; a CTA's shared memory fits."""
    h, c, o, ks, stride, pad = site
    oh = (h + 2 * pad - ks) // stride + 1
    m, k = batch * oh * oh, ks * ks * c
    p = _conv_plan(batch, oh, oh, o, k, SMS)
    assert conv_route(c) == "mma"
    assert p.bn == _tile_n(o) == min(o, MMA_TILES[-1]) in MMA_TILES
    assert p.n_tiles * p.bn == o
    assert (p.m_tiles - 1) * CONV_BM < m <= p.m_tiles * CONV_BM
    assert (p.stages - 1) * CONV_BK < k <= p.stages * CONV_BK
    shares = _split_shares(p.stages, p.splits)
    assert sum(shares) == p.stages and max(shares) == p.per_split
    assert p.splits in (1, 2, 4, 8) and p.splits <= MAX_SPLITS
    tiles = p.m_tiles * p.n_tiles
    assert _launch_plan(batch, oh, oh, o, c, ks, SMS) == p
    weights = p.stages * p.bn * CONV_BK
    if p.splits > 1:
        assert p.ctas == tiles and not p.resident
        assert min(shares) >= MIN_SPLIT_STAGES
        assert tiles * p.splits <= _cluster_ctas(p.splits, SMS) <= SMS
    else:
        assert p.ctas == min(tiles, SMS)
        assert sorted(_walk(p)) == [(i, j) for i in range(p.m_tiles)
                                    for j in range(p.n_tiles)]
        assert p.resident == (p.n_tiles == 1 and _tc_smem(
            p.bn, weights)[1] >= TC_MIN_RING)
    smem, nst = _tc_smem(p.bn, weights if p.resident else 0)
    assert smem <= TC_SMEM and nst >= (TC_MIN_RING if p.resident else 7)
    if tiles < SMS and p.splits < MAX_SPLITS:
        more = 2 * p.splits
        assert (more * MIN_SPLIT_STAGES > p.stages
                or tiles * more > _cluster_ctas(more, SMS))


def test_conv_plan_at_served_shapes():
    """The 26 sites at 14x14x256 take 98 x 2 tiles at batch 64, walked by
    132 persistent CTAs, and split K at batches 1 and 8 (26 tiles in
    clusters of 4: 104 CTAs; 4 tiles in clusters of 8); 7x7x512 at batch
    1 splits its 36 stages into a full cluster of 8 (4 tiles x 8 = 32
    CTAs), and at batch 64 its 100 tiles run unsplit (200 CTAs in
    clusters of 2 would not run at once); the 1x1 shortcut at 14x14x256
    -> 7x7x512 (two stages) never splits; the one-tile-wide maps keep
    their weights resident: 112x112 at batch 64 (36 KB of them, 6,272
    tiles) and 28x28x128 (144 KB, a ring of 5 stages of pixels)."""
    assert _conv_plan(64, 14, 14, 256, 2304, SMS) == \
        (128, 98, 2, 18, 1, 18, 132, False)
    assert _conv_plan(8, 14, 14, 256, 2304, SMS) == \
        (128, 13, 2, 18, 4, 5, 26, False)
    assert _conv_plan(1, 14, 14, 256, 2304, SMS) == \
        (128, 2, 2, 18, 8, 3, 4, False)
    assert _conv_plan(1, 7, 7, 512, 4608, SMS) == \
        (128, 1, 4, 36, 8, 5, 4, False)
    assert _conv_plan(64, 7, 7, 512, 4608, SMS) == \
        (128, 25, 4, 36, 1, 36, 100, False)
    for n in BATCHES:
        assert _conv_plan(n, 7, 7, 512, 256, SMS).splits == 1
    assert _conv_plan(64, 112, 112, 64, 576, SMS) == \
        (64, 6272, 1, 5, 1, 5, 132, True)
    assert _conv_plan(64, 28, 28, 128, 1152, SMS) == \
        (128, 392, 1, 9, 1, 9, 132, True)
    assert _tc_smem(128, 9 * 128 * CONV_BK)[1] == 5


def test_cluster_ctas_on_an_h100():
    """132 SMs: every SM unsplit and in clusters of 2; 120 in clusters of
    4 and of 8 (30 and 15 of them: what the card reports it holds)."""
    assert [_cluster_ctas(s, SMS) for s in (1, 2, 4, 8)] == \
        [132, 132, 120, 120]
    assert all(_cluster_ctas(s, SMS) % s == 0 for s in (1, 2, 4, 8))


def _mma_sites():
    """(H, W, C, KS, stride, pad) of every tensor-core site, once per
    shape: the int8 IR-50's and the three int8 detectors' at 288x320."""
    sites = [(h, h, c, ks, stride, pad)
             for h, c, _, ks, stride, pad in SITES[1:]]
    for family in ("mobilenet0.25", "slim", "rfb"):
        sites += [(s[1], s[2], s[3], s[5], s[6], s[7])
                  for s in _detector_conv_shapes(1, family)
                  if conv_route(s[3], s[8]) == "mma"]
    return list(dict.fromkeys(sites))


MMA_SITES = _mma_sites()


def test_mma_sites_are_ir50s_and_the_detectors():
    """The box depends on the input and the kernel, not on O: IR-50's 15
    tensor-core shapes read 12 distinct inputs (square maps, 112 to 7
    pixels), the detectors' 15 more (non-square maps, 72x80 to 9x10)."""
    assert len([s for s in MMA_SITES if s[0] == s[1]]) == 12
    assert len([s for s in MMA_SITES if s[0] != s[1]]) == 15
    assert all(conv_route(c) == "mma" for _, _, c, _, _, _ in MMA_SITES)


@pytest.mark.parametrize("site", MMA_SITES,
                         ids=lambda s: "h{}w{}c{}k{}s{}p{}".format(*s))
def test_im2col_box_at_each_site(site):
    """The box of every tensor-core site: its bounding box, walked from
    the lower corner at the traversal stride, visits exactly the first
    taps of the output pixels (-pad + stride * ow, ow < OW; the same in
    h), and the taps added to them reach the padding and nothing past it;
    the corners lie in a 4-D im2col map's range; a load is a tile's
    CONV_BM pixels of min(C, CONV_BK) channels (a swizzle span: 16 to
    128 bytes), and the loads of a stage fill its CONV_BK bytes of K.
    The C entry point takes the same numbers."""
    h, w, c, ks, stride, pad = site
    box = _im2col_box(c, ks, stride, pad)
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    assert box.lower == (-pad, -pad)
    assert box.upper == (pad - (ks - 1),) * 2
    assert box.stride == stride
    for size, out, lo, up in ((w, ow, box.lower[0], box.upper[0]),
                              (h, oh, box.lower[1], box.upper[1])):
        first = list(range(lo, size - 1 + up + 1, box.stride))
        assert first == [-pad + stride * i for i in range(out)]
        assert first[0] == -pad and first[-1] + ks - 1 <= size - 1 + pad
        assert -2 ** 7 <= lo <= 2 ** 7 - 1 and -2 ** 7 <= up <= 2 ** 7 - 1
    assert box.pixels == CONV_BM
    assert box.channels == min(c, CONV_BK) in (16, 32, 64, 128)
    assert box.loads * box.channels == CONV_BK
    # a load is whole 8-row groups of its swizzle (1,024 bytes and more
    # from 32 bytes a row on)
    assert box.channels == 16 or box.pixels * box.channels % 1024 == 0
    assert list(_box_arg(c, ks, stride, pad)) == [
        *box.lower, *box.upper, box.stride, box.pixels, box.channels]


def _first_taps(box, h, w, start, count):
    """The first taps (w, h, image) of ``count`` pixels of one im2col load
    from ``start``, as the TMA unit walks the bounding box: along w at the
    traversal stride, past the upper corner back to the lower one and on
    along h, past that to the next image."""
    (lw, lh), (uw, uh) = box.lower, box.upper
    cw, chh, cn = start
    out = []
    for _ in range(count):
        out.append((cw, chh, cn))
        cw += box.stride
        if cw > w - 1 + uw:
            cw, chh = lw, chh + box.stride
            if chh > h - 1 + uh:
                chh, cn = lh, cn + 1
    return out


def _conv_by_im2col_loads(x, wt, stride, pad):
    """The conv as the tensor-core kernel computes it, on numpy arrays:
    for each tile of CONV_BM pixels, the im2col loads of each stage of
    K (one tap's channels each, from the tile's first pixel, the tap as
    the offset, zeros off the image and past the last image), times the
    weights' (O, K) rows."""
    n, h, w, c = x.shape
    o, ks = wt.shape[:2]
    box = _im2col_box(c, ks, stride, pad)
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    m, k = n * oh * ow, ks * ks * c
    wk = wt.reshape(o, k).astype(np.int64)
    out = np.zeros((m, o), np.int64)
    for m0 in range(0, m, box.pixels):
        img, r = divmod(m0, oh * ow)
        row, col = divmod(r, ow)
        first = _first_taps(box, h, w, (col * stride - pad, row * stride - pad,
                                        img), box.pixels)
        a = np.zeros((box.pixels, k), np.int64)
        for kb in range(0, k, CONV_BK):
            for j in range(min(CONV_BK, k - kb) // box.channels):
                kj = kb + j * box.channels
                tap, c0 = divmod(kj, c)
                kh, kw = divmod(tap, ks)
                for i, (fw, fh, fn) in enumerate(first):
                    if fn < n and 0 <= fh + kh < h and 0 <= fw + kw < w:
                        a[i, kj:kj + box.channels] = \
                            x[fn, fh + kh, fw + kw, c0:c0 + box.channels]
        rows = min(box.pixels, m - m0)
        out[m0:m0 + rows] = (a @ wk.T)[:rows]
    return out.reshape(n, oh, ow, o)


# (N, H, W, C, O, KS, stride, pad): every load width (C 16 to 256), both
# kernel sizes, strides and paddings, odd maps (stride 2 ends a row past
# the image's last column), tiles that cross rows and images, M no
# multiple of 128 (the last tile's pixels past the last image: zeros)
IM2COL_CASES = [(2, 9, 7, 16, 24, 3, 1, 1), (3, 11, 13, 32, 16, 3, 2, 1),
                (2, 15, 9, 64, 8, 3, 2, 0), (3, 9, 9, 64, 16, 1, 2, 0),
                (2, 7, 7, 256, 8, 3, 1, 1), (1, 5, 5, 128, 16, 3, 2, 1),
                (2, 6, 6, 16, 8, 1, 1, 0), (2, 13, 11, 32, 8, 1, 2, 0)]


@pytest.mark.parametrize("case", IM2COL_CASES,
                         ids=lambda s: "n{}h{}w{}c{}o{}k{}s{}p{}".format(*s))
def test_im2col_loads_compute_the_conv(case):
    """The tiles' im2col loads, walked as the box says, give the plain
    conv's exact sums at every pixel."""
    n, h, w, c, o, ks, stride, pad = case
    rng = np.random.default_rng(sum(case))
    x = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    wt = rng.integers(-127, 128, (o, ks, ks, c)).astype(np.int8)
    ref = conv_s8_reference(torch.tensor(x), torch.tensor(wt), stride, pad)
    np.testing.assert_array_equal(_conv_by_im2col_loads(x, wt, stride, pad),
                                  ref.numpy())


@pytest.mark.parametrize("c,route", [(3, "dp4a"), (4, "dp4a"), (8, "dp4a"),
                                     (16, "mma"), (64, "mma"), (512, "mma")])
def test_conv_route(c, route):
    assert conv_route(c) == route
    assert (c >= MMA_MIN_C) == (route == "mma")
    if c % 4 == 0:
        # the plan the C entry point takes names the route: bn = 0 is dp4a
        plan = _launch_plan(1, 7, 7, 64, c, 3, SMS)
        assert (plan == _NO_PLAN) == (route == "dp4a")
        assert (plan.bn == 0) == (route == "dp4a")


def test_overflow_bound_covers_ir50():
    """The largest K of IR-50 (3x3x512 = 4,608) is far below the bound at
    which 128**2 * K could reach 2**31."""
    assert max(ks * ks * c for _, c, _, ks, _, _ in SITES) == 4608 < MAX_K
    assert 128 ** 2 * MAX_K < 2 ** 31 <= 128 ** 2 * (MAX_K + 1)


@pytest.mark.parametrize("family", ["mobilenet0.25", "slim", "rfb"])
def test_detector_site_list_is_what_a_forward_runs(family, monkeypatch):
    """The int8 sites the kernel tests take for a detector at 288x320
    are those its int8 forward runs (shapes, strides,
    padding, groups, each as often), and each site's route is the one its
    channels and groups choose."""
    net = RetinaFace() if family == "mobilenet0.25" else LightDet(family)
    q = quantize_detector(net.eval())
    seen = []

    def record(x, wq, wscale, stride=1, padding=0, groups=1, ascale=None):
        n, h, w, c = x.shape
        seen.append((n, h, w, c, wq.shape[0], wq.shape[2], stride, padding,
                     groups))
        oh = (h + 2 * padding - wq.shape[2]) // stride + 1
        ow = (w + 2 * padding - wq.shape[3]) // stride + 1
        return torch.zeros((n, oh, ow, wq.shape[0]), dtype=x.dtype)
    monkeypatch.setattr(TL, "conv2d_int8", record)
    with torch.inference_mode():
        q(torch.zeros((1, *DET_HW, 3)))
    expected = _detector_conv_shapes(1, family)
    assert Counter(seen) == Counter(expected)
    routes = Counter(conv_route(c, g) for _, _, _, c, _, _, _, _, g
                     in expected)
    dw = {"mobilenet0.25": 13, "slim": 12, "rfb": 11}[family]
    assert routes["dw"] == dw
    # the stem (3 -> 8 or 16) and RetinaFace's first pointwise (8 -> 16)
    assert routes["dp4a"] == (2 if family == "mobilenet0.25" else 1)
    assert all(o % 8 == 0 for _, _, _, _, o, _, _, _, _ in expected)


@pytest.mark.parametrize("o,bn", [(8, 8), (16, 16), (24, 24), (32, 32),
                                  (40, 48), (192, 96), (200, 128)])
def test_conv_plan_covers_narrow_outputs(o, bn):
    """A narrow O takes a tile of its own width where the kernel has that
    width (8, 16, 24, 32), else the least wider one (40 -> 48, its last 8
    channels past O: zero weights, stores skipped); an O past 128 splits
    into as few tiles of at most 128 as hold it (192: two of 96; 200: two
    of 128, the second partly past O)."""
    p = _conv_plan(8, 36, 40, o, 9 * 16, SMS)
    assert p.bn == bn in MMA_TILES
    assert (p.n_tiles - 1) * p.bn < o <= p.n_tiles * p.bn
    # unsplit (two stages): one n tile keeps its weights resident
    assert p.splits == 1
    assert p.resident == (p.n_tiles == 1)


@pytest.mark.parametrize("o", list(range(8, 264, 8)) + [384, 448, 512])
def test_tile_width_is_the_least_wgmma_width(o):
    """Every multiple of 8 up to 256 (and 384 to 512): the tiles are as
    few as MMA_TILES[-1] allows, and each the least width of MMA_TILES
    that holds an even share of O."""
    bn = _tile_n(o)
    n_tiles = -(-o // bn)
    assert n_tiles == -(-o // MMA_TILES[-1])
    share = -(-o // n_tiles)
    assert bn >= share and all(t < share for t in MMA_TILES if t < bn)
    assert bn % 8 == 0


@pytest.mark.parametrize("c", [8, 16, 64, 256])
def test_depthwise_route_takes_no_plan(c):
    assert conv_route(c, groups=c) == "dw"
    assert _launch_plan(8, 36, 40, c, c, 3, SMS, groups=c) == _NO_PLAN


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [8, 24, 64])
def test_wrapper_runs_depthwise_plain_version_on_cpu(c, stride):
    """On CPU tensors the wrapper runs the plain version with ``groups``,
    which sums each channel's 9 taps alone."""
    from facekit_torch.ops.conv_s8 import (_conv_s8_cuda, conv_s8,
                                           conv_s8_reference)
    rng = np.random.default_rng(c + stride)
    x = torch.tensor(rng.integers(-127, 128, (2, 9, 7, c)), dtype=torch.int8)
    w = torch.tensor(rng.integers(-127, 128, (c, 3, 3, 1)), dtype=torch.int8)
    before = conv_s8.launches
    got = conv_s8(x, w, stride, 1, groups=c)
    assert conv_s8.launches == before
    assert torch.equal(got, conv_s8_reference(x, w, stride, 1, c))
    xp = torch.nn.functional.pad(x.int(), (0, 0, 1, 1, 1, 1))
    for ch in (0, c - 1):
        patch = xp[1, 0:3, 0:3, ch]
        assert int(got[1, 0, 0, ch]) == int((patch * w[ch, :, :, 0]).sum())
    with pytest.raises(ValueError, match="CUDA"):
        _conv_s8_cuda(x, w, stride, 1, c)


SMEM_PER_SM = 233_472          # 228 KiB of shared memory an H100 SM offers
SMEM_PER_CTA_RESERVED = 1_024  # kept by the system for each CTA


def _band_sites():
    """(N, H, W, C, O, KS, stride, pad, groups) of every site of the two
    band routes, once per shape: the int8 IR-50's stem at the served
    batches and the dp4a and depthwise sites of the three int8 detectors
    at batches 1 and 8."""
    sites = [(n, 112, 112, 3, 64, 3, 1, 1, 1) for n in BATCHES]
    for n in (1, 8):
        for family in ("mobilenet0.25", "slim", "rfb"):
            sites += [s for s in _detector_conv_shapes(n, family)
                      if conv_route(s[3], s[8]) != "mma"]
    return list(dict.fromkeys(sites))


BAND_SITES = _band_sites()


def test_band_sites_are_the_cuda_core_routes():
    """The IR-50 stem at three batches; at two batches each, the
    detectors' two stems (3 -> 8, 3 -> 16), RetinaFace's 8 -> 16 1x1 and
    the 11 distinct depthwise shapes."""
    routes = Counter(conv_route(s[3], s[8]) for s in BAND_SITES)
    assert routes == {"dp4a": 3 + 2 * 3, "dw": 2 * 11}


@pytest.mark.parametrize(
    "site", BAND_SITES,
    ids=lambda s: "n{0}h{1}w{2}c{3}o{4}k{5}s{6}g{8}".format(*s))
def test_band_plan_covers_each_site(site):
    """The bands of a channel tile, walked as the kernel walks them (CTA
    i takes bands i, i + ctas, ...), cover every output row of every
    image once; the channel tiles cover O once; a CTA's shared memory is
    the kernel's layout and fits BAND_CTAS_PER_SM CTAs in an SM; no CTA
    is without a band; and a band takes the fewest rows with which the
    bands fit in one round of the CTAs the card holds, up to
    BAND_MAX_ROWS and as far as BAND_SMEM allows."""
    n, h, w, c, o, ks, stride, pad, groups = site
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    p = _band_plan(n, h, w, c, o, ks, stride, pad, groups, SMS)
    if groups > 1:
        assert c % p.ch == 0 and p.ch % 4 == 0 and p.chunks == c // p.ch
    else:
        # every served O has its exact tile, and its rows fit unsplit
        assert p.ch == o in DENSE_TILES and p.chunks == 1
    assert (p.chunks - 1) * p.ch < o <= p.chunks * p.ch
    per_img = -(-oh // p.rows)
    assert p.bands == n * per_img
    rows = Counter()
    for cta in range(p.ctas):
        for b in range(cta, p.bands, p.ctas):
            img, first = divmod(b, per_img)
            rows.update((img, r) for r in range(first * p.rows,
                                                min(oh, (first + 1) *
                                                    p.rows)))
    assert rows == Counter({(i, r): 1 for i in range(n) for r in range(oh)})
    assert p.smem == _band_smem(w, c, ks, stride, p.rows, p.ch,
                                groups) <= BAND_SMEM
    assert BAND_CTAS_PER_SM * (p.smem + SMEM_PER_CTA_RESERVED) <= SMEM_PER_SM
    slots = BAND_CTAS_PER_SM * SMS
    assert 1 <= p.ctas == min(p.bands, slots // p.chunks)
    assert p.rows <= BAND_MAX_ROWS
    if p.rows > 1:
        assert n * -(-oh // (p.rows - 1)) * p.chunks > slots
    if p.bands * p.chunks > slots and p.rows < min(oh, BAND_MAX_ROWS):
        assert _band_smem(w, c, ks, stride, p.rows + 1, p.ch,
                          groups) > BAND_SMEM


def test_band_plan_at_served_shapes():
    """The IR-50 stem takes bands of one row at batch 1 (112 bands, fewer
    than the SMs), four at batch 8 (224 bands, one round of 264 CTAs) and
    BAND_MAX_ROWS at batch 64 (896 bands walked by 264 CTAs). The
    detectors' 144-row maps take five rows a band at batch 8 (232 bands);
    the late 9x10x256 depthwise map splits its channels so that its 9
    rows still give every SM a band."""
    assert _band_plan(1, 112, 112, 3, 64, 3, 1, 1, 1, SMS)[:5] == \
        (1, 64, 1, 112, 112)
    assert _band_plan(8, 112, 112, 3, 64, 3, 1, 1, 1, SMS)[:5] == \
        (4, 64, 1, 224, 224)
    assert _band_plan(64, 112, 112, 3, 64, 3, 1, 1, 1, SMS)[:5] == \
        (BAND_MAX_ROWS, 64, 1, 896, 264)
    assert _band_plan(8, 288, 320, 3, 8, 3, 2, 1, 1, SMS)[:5] == \
        (5, 8, 1, 232, 232)
    assert _band_plan(8, 144, 160, 16, 16, 3, 1, 1, 16, SMS)[:5] == \
        (5, 16, 1, 232, 232)
    assert _band_plan(1, 9, 10, 256, 256, 3, 1, 1, 256, SMS)[:5] == \
        (1, 16, 16, 9, 9)
    assert _band_plan(8, 9, 10, 256, 256, 3, 1, 1, 256, SMS)[:5] == \
        (1, 128, 2, 72, 72)


@pytest.mark.parametrize("o", [8, 16, 24, 32, 40, 64, 128, 192, 200])
def test_dense_band_tile_is_o_or_64(o):
    """An O in DENSE_TILES takes a tile of exactly O channels; any other
    multiple of 8 takes 64-channel tiles, the last partly past O."""
    p = _band_plan(2, 13, 11, 3, o, 3, 1, 1, 1, SMS)
    assert p.ch == (o if o in DENSE_TILES else 64)
    assert p.chunks == -(-o // p.ch)


@pytest.mark.parametrize("shape", [(1, 8, 4000, 3, 8, 3, 1, 1, 1),
                                   (1, 8, 4000, 4, 4, 3, 1, 1, 4)])
def test_band_plan_refuses_a_row_that_does_not_fit(shape):
    """The input rows of a band of one row 4,000 pixels wide do not fit in
    BAND_SMEM (depthwise: even at its least tile, C = 4): refused, no
    other route."""
    with pytest.raises(ValueError, match="does not fit"):
        _band_plan(*shape, SMS)


@pytest.mark.parametrize("shape", [(1, 8, 1000, 64, 64, 3, 1, 1, 64),
                                   (1, 8, 600, 256, 256, 3, 1, 1, 256)])
def test_band_plan_splits_the_channels_of_a_wide_row(shape):
    """Where a depthwise band of one row of every channel does not fit,
    the channels split over CTAs, halving the tile until a row fits."""
    n, h, w, c, o, ks, stride, pad, groups = shape
    p = _band_plan(*shape, SMS)
    assert p.chunks > 1 and p.smem <= BAND_SMEM
    assert _band_smem(w, c, ks, stride, 1, 2 * p.ch, groups) > BAND_SMEM
