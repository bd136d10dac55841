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

from facekit_torch.ops.similarity import (_cosine_topk_cuda, cosine_topk,
                                          cosine_topk_reference)

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


# -- the CUDA kernel (skipped without a card) ---------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the search kernel is CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,count", [(1, 1, N), (2, 3, 777), (3, 5, N),
                                       (8, 3, 777), (256, 64, N), (5, 8, 3)])
def test_kernel_matches_plain(cuda_device, dtype, b, k, count):
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
@pytest.mark.parametrize("b", [1, 2, 5])
def test_kernel_ties_and_checks(cuda_device, b):
    g, q = _data(7, b=b, ties=True)
    gt, qt = torch.tensor(g, device=cuda_device), torch.tensor(q, device=cuda_device)
    _, idx = cosine_topk(gt, qt, N, 2)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  np.stack([np.arange(b), 600 + np.arange(b)], 1))
    with pytest.raises(ValueError):
        cosine_topk(gt, qt, N, 65)
    with pytest.raises(TypeError):
        cosine_topk(gt, qt.to(torch.bfloat16), N, 1)
