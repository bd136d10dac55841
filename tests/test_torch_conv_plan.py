"""The launch plan of facekit_torch's s8 conv kernel.

``conv_route`` (which kernel a channel count runs), ``_conv_plan`` (the
tensor-core route's CTA tile and K split) and ``_launch_plan`` (the plan
the C entry point takes, which names the route) are pure functions of the
shapes and the card's SM count, so they are checked here on the CPU at
every conv site of the int8 IR-50 at the served batches; the kernel itself
is in tests/test_torch_kernels.py. Imports neither JAX nor facekit.
"""

import pytest

from facekit_torch.models.arcface import block_specs
from facekit_torch.ops.conv_s8 import (CONV_BK, CONV_BM, MAX_K, MAX_SPLITS,
                                       MIN_SPLIT_STAGES, MMA_MIN_C, _NO_PLAN,
                                       _conv_plan, _launch_plan, conv_route)

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
