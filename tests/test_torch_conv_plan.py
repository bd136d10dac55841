"""The launch plan of facekit_torch's s8 conv kernel.

``conv_route`` (which kernel a channel count and ``groups`` run),
``_conv_plan`` (the tensor-core route's CTA tile and K split),
``_launch_plan`` (the plan the C entry point takes, which names the dense
route) and ``_band_plan`` (the row bands of the two CUDA-core routes)
are pure functions of the shapes and the card's SM count, so they
are checked here on the CPU at every conv site of the int8 IR-50 at the
served batches and at every site of the int8 detectors (whose list the
kernel tests take is held here to the sites a forward runs); the kernel
itself is in tests/test_torch_kernels.py. Imports neither JAX nor
facekit.
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
                                       MAX_SPLITS, MIN_SPLIT_STAGES,
                                       MMA_MIN_C, _NO_PLAN, _band_plan,
                                       _band_smem, _conv_plan, _launch_plan,
                                       conv_route)
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


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("site", SITES[1:],
                         ids=lambda s: "h{}c{}o{}k{}s{}".format(*s[:5]))
def test_conv_plan_covers_each_site(site, batch):
    """Tiles cover the pixels and channels, the splits cover K in whole
    stages with no empty split, none but the last below MIN_SPLIT_STAGES
    and at most MAX_SPLITS of them (one cluster), and each split takes no
    more stages than a CTA per SM, MAX_SPLITS or MIN_SPLIT_STAGES makes
    it take."""
    h, c, o, ks, stride, pad = site
    oh = (h + 2 * pad - ks) // stride + 1
    m, k = batch * oh * oh, ks * ks * c
    p = _conv_plan(batch, oh, oh, o, k, SMS)
    assert conv_route(c) == "mma"
    assert p.bn == (128 if o % 128 == 0 else 64)
    assert p.n_tiles * p.bn == o
    assert (p.m_tiles - 1) * CONV_BM < m <= p.m_tiles * CONV_BM
    assert (p.stages - 1) * CONV_BK < k <= p.stages * CONV_BK
    assert (p.splits - 1) * p.per_split < p.stages <= p.splits * p.per_split
    tiles = p.m_tiles * p.n_tiles
    assert 1 <= p.splits <= MAX_SPLITS
    if tiles < SMS:
        assert p.per_split <= max(MIN_SPLIT_STAGES, -(-p.stages // MAX_SPLITS),
                                  -(-p.stages * tiles // SMS))
    assert _launch_plan(batch, oh, oh, o, c, ks, SMS) == p
    if tiles >= SMS or p.stages <= MIN_SPLIT_STAGES:
        assert (p.splits, p.per_split) == (1, p.stages)
    if p.splits > 1:
        assert p.per_split >= MIN_SPLIT_STAGES
    # the stages shared as evenly as whole stages allow
    assert p.per_split == -(-p.stages // p.splits)


def test_conv_plan_at_served_shapes():
    """The 26 sites at 14x14x256 take one wave of 98 x 2 tiles at batch 64
    and split K at batches 1 and 8; 7x7x512 at batch 1 splits its 36
    stages into a full cluster of 8 (4 tiles x 8 = 32 CTAs); the 1x1
    shortcut at 14x14x256 -> 7x7x512 (two stages) never splits."""
    assert _conv_plan(64, 14, 14, 256, 2304, SMS) == (128, 98, 2, 18, 1, 18)
    assert _conv_plan(8, 14, 14, 256, 2304, SMS) == (128, 13, 2, 18, 6, 3)
    assert _conv_plan(1, 14, 14, 256, 2304, SMS) == (128, 2, 2, 18, 6, 3)
    assert _conv_plan(1, 7, 7, 512, 4608, SMS) == (128, 1, 4, 36, 8, 5)
    assert _conv_plan(64, 7, 7, 512, 4608, SMS) == (128, 25, 4, 36, 2, 18)
    for n in BATCHES:
        assert _conv_plan(n, 7, 7, 512, 256, SMS).splits == 1
    # 112x112 at batch 64: 64 output channels, no split
    assert _conv_plan(64, 112, 112, 64, 576, SMS) == (64, 6272, 1, 5, 1, 5)


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


@pytest.mark.parametrize("o", [8, 16, 24, 32, 40, 192, 200])
def test_conv_plan_covers_narrow_outputs(o):
    """An O that is no multiple of 64 takes 64-channel tiles, the last
    partly past O (its rows zero-filled, its stores skipped)."""
    p = _conv_plan(8, 36, 40, o, 9 * 16, SMS)
    assert p.bn == (128 if o % 128 == 0 else 64)
    assert (p.n_tiles - 1) * p.bn < o <= p.n_tiles * p.bn


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
