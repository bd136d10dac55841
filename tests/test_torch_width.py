"""Gallery widths other than 512 (``rec_outputDim``).

The search kernels are built for D = 512; the port zero-pads narrower
rows and queries to it (``ops.similarity.pad_width``), which is exact. On
the CPU the wrappers run the plain versions, so these tests hold the
width handling that the card runs too: the padding itself, the store's
rows, and a server with ``rec_outputDim: 256`` and a 256-wide weight file
answering ``/recognize`` as facekit's server does (similarities within
1e-5, f32). Wider than 512 raises on every device. The kernels at D = 128
and 256 are the ``cuda`` tests in ``tests/test_torch_kernels.py``.
"""

import contextlib
import json

import cv2
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.server import FaceServer as JaxServer
from facekit.server import make_app as jax_make_app
from facekit_torch.config import FaceKitConfig
from facekit_torch.gallery.store import GalleryStore
from facekit_torch.ops.similarity import (_cosine_topk_cuda,
                                          _cosine_topk_int8_cuda, cosine_topk,
                                          cosine_topk_int8,
                                          cosine_topk_int8_reference,
                                          cosine_topk_reference, pad_width,
                                          quantize_rows_int8)
from facekit_torch.server import FaceServer, make_app
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params, save_params)

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402


def _unit(rng, shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("d", [128, 256])
def test_zero_padding_is_exact(d):
    """Scores and indices of the padded search equal the unpadded one's
    bit for bit in int8; f32 scores to 1e-6 (another sum length)."""
    rng = np.random.default_rng(163)
    g, q = torch.tensor(_unit(rng, (300, d))), torch.tensor(_unit(rng, (5, d)))
    gp, qp = pad_width(g), pad_width(q)
    assert gp.shape == (300, 512) and torch.equal(gp[:, :d], g)
    assert not gp[:, d:].any()
    v, i = cosine_topk_reference(g, q, 280, 4)
    pv, pi = cosine_topk_reference(gp, qp, 280, 4)
    assert torch.equal(i, pi)
    np.testing.assert_allclose(pv.numpy(), v.numpy(), rtol=0, atol=1e-6)
    gq, gs = quantize_rows_int8(g)
    pq, ps = quantize_rows_int8(gp)
    assert torch.equal(ps, gs) and torch.equal(pq[:, :d], gq)
    iv, ii = cosine_topk_int8_reference(gq, gs, q, 280, 4)
    pv, pi = cosine_topk_int8_reference(pq, ps, qp, 280, 4)
    assert torch.equal(ii, pi) and torch.equal(iv, pv)
    # queries narrower than a padded gallery: the wrappers pad them
    wv, wi = cosine_topk(gp, q, 280, 4)
    assert torch.equal(wi, i)
    np.testing.assert_allclose(wv.numpy(), v.numpy(), rtol=0, atol=1e-6)
    wv, wi = cosine_topk_int8(pq, ps, q, 280, 4)
    assert torch.equal(wi, ii) and torch.equal(wv, iv)


def test_wider_than_512_raises():
    g = torch.zeros((4, 640))
    with pytest.raises(ValueError, match="up to 512"):
        cosine_topk(g, torch.zeros((1, 640)), 4, 1)
    gq, gs = quantize_rows_int8(g)
    with pytest.raises(ValueError, match="up to 512"):
        cosine_topk_int8(gq, gs, torch.zeros((1, 640)), 4, 1)
    # the kernels' paths check the width before the device
    with pytest.raises(ValueError, match="up to 512"):
        _cosine_topk_cuda(g, torch.zeros((1, 640)), 4, 1)
    with pytest.raises(ValueError, match="up to 512"):
        _cosine_topk_int8_cuda(gq, gs, torch.zeros((1, 640)), 4, 1)
    with pytest.raises(ValueError, match="queries no wider"):
        cosine_topk(torch.zeros((4, 256)), torch.zeros((1, 512)), 4, 1)
    with pytest.raises(ValueError, match="up to 512"):
        GalleryStore(embed_dim=1024, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_store_searches_a_narrow_gallery(dtype):
    """A 256-wide store on the CPU keeps rows 256 wide, its width for
    load, add and search; the answers are the plain search's."""
    rng = np.random.default_rng(164)
    emb = _unit(rng, (10, 256))
    store = GalleryStore(embed_dim=256, buckets=(16,), dtype=dtype,
                         device="cpu")
    store.load([f"u{i}" for i in range(9)], emb[:9])
    store.add("u9", emb[9])
    assert store.snapshot().arr.shape == (16, 256)
    vals, idx, names = store.search(emb[[3, 9]], k=2)
    assert [names[i] for i in idx[:, 0]] == ["u3", "u9"]


_CFG = dict(rec_network="ir_tiny", compute_dtype="float32",
            gallery_dtype="float32", gallery_bucket_sizes=(16, 64),
            rec_outputDim=256)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w256")
    weights = str(tmp / "ir_tiny_256.msgpack")
    save_params(random_arcface_params("ir_tiny", seed=16, embed_dim=256),
                weights)
    det = random_retinaface_params(seed=0)
    ref = JaxServer(JaxConfig(database_path=str(tmp / "jax.db"),
                              use_pallas_search=False, rec_weights=weights,
                              **_CFG), det_params=det, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp / "torch.db"),
                                    rec_weights=weights, **_CFG),
                      det_params=det, warmup=False, device="cpu")
    yield ref, ours
    ours.close()


@contextlib.asynccontextmanager
async def _clients(servers):
    clients = [TestClient(TestServer(jax_make_app(servers[0]))),
               TestClient(TestServer(make_app(servers[1])))]
    for c in clients:
        await c.start_server()
    try:
        yield clients
    finally:
        for c in clients:
            await c.close()


async def _both(clients, method, path, **kw):
    out = []
    for c in clients:
        r = await getattr(c, method)(path, **kw)
        out.append((r.status, await r.text()))
    return out


async def test_256_wide_server_matches_facekit(servers, tmp_path):
    ref_server, ours_server = servers
    assert ours_server.gallery.embed_dim == 256
    rng = np.random.default_rng(165)
    paths = []
    for i in range(3):
        ok, buf = cv2.imencode(".jpg", rng.integers(0, 256, (112, 112, 3),
                                                    dtype=np.uint8))
        paths.append(tmp_path / f"f{i}.jpg")
        paths[-1].write_bytes(buf.tobytes())
    async with _clients(servers) as clients:
        for uid in ("ann", "bo", "cy"):
            a, b = await _both(clients, "post", "/insert/user", data=json.dumps(
                {"userId": uid, "userName": uid}))
            assert a == b
        a, b = await _both(clients, "post", "/insert/face", data=json.dumps(
            {"data": [{"userId": u, "imgPath": str(p)}
                      for u, p in zip(("ann", "bo", "cy"), paths)]}))
        assert a == b and a[1].count("inserted successfully") == 3
        a, b = await _both(clients, "get", "/reload")
        assert a == b == (200, "Success\n")
        for p, uid in zip(paths, ("ann", "bo", "cy")):
            a, b = await _both(clients, "post", "/recognize",
                               data=p.read_bytes())
            assert a[0] == b[0] == 200
            ra, rb = json.loads(a[1]), json.loads(b[1])
            assert abs(ra.pop("similarity") - rb.pop("similarity")) < 1e-5
            assert ra == rb and rb["userId"] == uid
    emb = ours_server.pipeline.embed_cropped(cv2.imread(str(paths[0])))
    assert emb.shape == (256,)
