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
    """The plan of the CUDA-core pass 1 (f32, bf16 and int8 at B <= 8):
    about four CTAs per SM, each a multiple of 256 rows."""
    per = -(-n_rows // (4 * sms))
    rows_per_cta = max(256, -(-per // 256) * 256)
    return rows_per_cta, -(-n_rows // rows_per_cta)


def _tensor_cores(kind, b):
    """Whether the wrappers run pass 1 on tensor cores: bf16 and int8
    batches from MMA_MIN_B on, as the C entry points' rule B > 8."""
    return kind in ("bf16", "int8") and b >= MMA_MIN_B


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("b", [1, 8, 9, 32, 64, 256])
@pytest.mark.parametrize("n_rows", [33, 1000, 1 << 20])
def test_search_plan(n_rows, b, kind):
    tensor_cores = _tensor_cores(kind, b)
    rows_per_cta, chunks = _search_plan(n_rows, b, tensor_cores, SMS)
    assert rows_per_cta * chunks >= n_rows
    assert (chunks - 1) * rows_per_cta < n_rows       # no empty chunk
    if n_rows == 33:
        assert chunks == 1
    if tensor_cores:
        assert rows_per_cta % MMA_ROWS == 0
        # about one CTA per SM over the (query tiles, chunks) grid
        assert -(-b // MMA_QUERIES) * chunks <= SMS
    else:
        assert (rows_per_cta, chunks) == _cuda_core_plan(n_rows, SMS)


def test_search_plan_fills_the_card_at_full_gallery():
    """At the top gallery bucket the tensor-core path launches one wave:
    4 query tiles x 33 chunks at B = 256, 131 chunks at B = 32 (bf16) and
    B = 64 (int8, the served /recognize bucket 64)."""
    assert _search_plan(1 << 20, 256, _tensor_cores("bf16", 256),
                        SMS) == (31872, 33)
    assert _search_plan(1 << 20, 32, _tensor_cores("bf16", 32),
                        SMS) == (8064, 131)
    assert _search_plan(1 << 20, 64, _tensor_cores("int8", 64),
                        SMS) == (8064, 131)
    assert _search_plan(1 << 20, 256, _tensor_cores("int8", 256),
                        SMS) == (31872, 33)
    assert MMA_MIN_B == 9          # the C entry points' rule: B > 8
