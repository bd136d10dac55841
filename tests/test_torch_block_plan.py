"""The bf16 fused block's launch plan (``ir_block.bf16_plan``, the mirror
of ``bf16_plan`` in ``ops/csrc/ir_block.cu``) against the card's limits,
on the CPU. The ``cuda`` test ``test_ir_block_bf16_plan_is_the_kernels``
in tests/test_torch_kernels.py holds the mirror to the C side."""

import pytest

from facekit_torch.ops.ir_block import H100_SMS, _pass_tiles, bf16_plan

# (H = W, C) of IR-50's stride-1 identity blocks
IR50_SHAPES = [(56, 64), (28, 128), (14, 256), (7, 512)]
# the batches the served paths and chip_smoke.py run the blocks at
BATCHES = [1, 4, 8, 32, 64]
SMEM_PER_CTA = 232448          # 227 KB, the most a CTA may take on an H100


@pytest.mark.parametrize("hw,c", IR50_SHAPES)
@pytest.mark.parametrize("n", BATCHES)
def test_bf16_plan_fits_the_card(n, hw, c):
    """Every IR-50 shape and batch has a plan: at most 227 KB of shared
    memory a CTA, a cluster of C/64 CTAs (at most the portable 8), conv2 in
    one pass, conv1 in whole passes, and one CTA
    per cluster rank, band and image (or pair of images at 7x7)."""
    plan = bf16_plan(n, hw, hw, c, H100_SMS)
    assert plan is not None
    assert plan.smem <= SMEM_PER_CTA
    assert plan.cluster == c // 64 <= 8
    assert 1 <= plan.rows <= hw and plan.tiles2 <= _pass_tiles(c)
    # conv1 of a band computes u on its rows and one either side, in the
    # image; the most of any band, at every position of a row of hw + 2
    rows1 = max(min(r0 + plan.rows + 1, hw) - max(r0 - 1, 0)
                for r0 in range(0, hw, plan.rows))
    assert plan.tiles1 == -(-rows1 * (hw + 2) // 64)
    # two images a CTA only where each is one tile in both convs
    assert plan.images in (1, 2) and n % plan.images == 0
    assert plan.images == 1 or plan.tiles1 == plan.tiles2 == 1
    assert plan.ctas == -(-hw // plan.rows) * (c // 64) * n // plan.images


def test_bf16_plan_refuses_what_no_band_fits():
    """A row wider than 382 positions, or one whose band of a single row
    would take more than 227 KB, has no plan (the wrapper raises)."""
    assert bf16_plan(1, 4, 383, 64) is None
    assert bf16_plan(1, 9, 200, 512) is None
    assert bf16_plan(1, 9, 100, 64) is not None


def test_bf16_pass_tiles_keep_chains_short():
    """A pass takes 6 m64 tiles up to 128 channels and 2 from 256 on, so
    that no accumulator sums more than 96 of a conv's 9*C/16 k16 steps
    (3 accumulators a warpgroup, split over its tiles)."""
    assert [_pass_tiles(c) for c in (64, 128, 256, 512)] == [6, 6, 2, 2]
    for c in (64, 128, 256, 512):
        per_warpgroup = -(-_pass_tiles(c) // 2)
        assert -(-(9 * c // 16) // (3 // per_warpgroup)) <= 96


def test_bf16_plan_fills_the_card_at_batch_8():
    """At batch 8, the bucket WS /inference and /recognize run most, no
    IR-50 shape takes more than one round of CTAs over the SMs."""
    for hw, c in IR50_SHAPES:
        assert bf16_plan(8, hw, hw, c, H100_SMS).ctas <= H100_SMS
