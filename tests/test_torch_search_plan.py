"""The launch plan of facekit_torch's gallery-search kernels.

``_search_plan`` is a pure function of the shapes and the card's SM count,
so it is checked here on the CPU; the kernels themselves are in
tests/test_torch_kernels.py. Imports neither JAX nor facekit.
"""

import pytest

from facekit_torch.ops.similarity import (MMA_MIN_B, MMA_QUERIES, MMA_ROWS,
                                          _search_plan)

SMS = 132                      # an H100 SXM


def _cuda_core_plan(n_rows, sms):
    """The plan of the CUDA-core pass 1 (f32, bf16 at B <= 8, int8): about
    four CTAs per SM, each a multiple of 256 rows."""
    per = -(-n_rows // (4 * sms))
    rows_per_cta = max(256, -(-per // 256) * 256)
    return rows_per_cta, -(-n_rows // rows_per_cta)


@pytest.mark.parametrize("is_bf16", [True, False])
@pytest.mark.parametrize("b", [1, 8, 9, 32, 64, 256])
@pytest.mark.parametrize("n_rows", [33, 1000, 1 << 20])
def test_search_plan(n_rows, b, is_bf16):
    rows_per_cta, chunks = _search_plan(n_rows, b, is_bf16, SMS)
    assert rows_per_cta * chunks >= n_rows
    assert (chunks - 1) * rows_per_cta < n_rows       # no empty chunk
    if n_rows == 33:
        assert chunks == 1
    if is_bf16 and b >= MMA_MIN_B:
        assert rows_per_cta % MMA_ROWS == 0
        # about one CTA per SM over the (query tiles, chunks) grid
        assert -(-b // MMA_QUERIES) * chunks <= SMS
    else:
        assert (rows_per_cta, chunks) == _cuda_core_plan(n_rows, SMS)


def test_search_plan_fills_the_card_at_full_gallery():
    """At the top gallery bucket the tensor-core path launches one wave:
    4 query tiles x 33 chunks at B = 256, 131 chunks at B = 32."""
    assert _search_plan(1 << 20, 256, True, SMS) == (31872, 33)
    assert _search_plan(1 << 20, 32, True, SMS) == (8064, 131)
    assert MMA_MIN_B == 9          # the C entry point's rule: B > 8
