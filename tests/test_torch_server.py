"""facekit_torch's server against facekit's, response for response.

Both servers get the same parameters (drawn with numpy) and the same
requests through aiohttp's test client; bodies must match verbatim and
similarities within 1e-5 in f32 (within INT8_SIM_ATOL for the int8
embedder, see there). Also: either package reads the other's database,
unported configs are refused, the int8 configs start and calibrate, and
importing the port loads no JAX and no ``facekit`` module.
"""

import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.db import Database as JaxDatabase
from facekit.models import retinaface_init
from facekit.server import FaceServer as JaxServer
from facekit.server import make_app as jax_make_app
from facekit_torch.config import FaceKitConfig, load_config
from facekit_torch.db import Database
from facekit_torch.server import FaceServer, make_app
from facekit_torch.server.app import main as server_main
from facekit_torch.weights import random_arcface_params

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMMON = dict(rec_network="ir_tiny", compute_dtype="float32",
               gallery_dtype="float32", gallery_bucket_sizes=(16, 64))
# the throughput profile's shape at ir_tiny: int8 embedder and gallery,
# batch buckets 1, 8 and 64
_INT8 = dict(_COMMON, gallery_dtype="int8", rec_quantize=True,
             extras={"server_batchBuckets": [1, 8, 64]})
# Both int8 embedders agree per conv site bit for bit, but 1-ulp
# differences of the float layers between them (XLA's rsqrt and fused
# multiply-adds) turn into whole int8 steps where they straddle a rounding
# boundary, and the steps compound: end to end the f32 embeddings differ
# by up to about 1e-2 in L2 at ir_tiny (tests/test_torch_int8_model.py).
# A similarity moves by that difference's component along the gallery
# row; the largest measured in this file's int8 test is 3.6e-4.
INT8_SIM_ATOL = 2e-3


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    import jax
    tmp = tmp_path_factory.mktemp("dbs")
    params = random_arcface_params("ir_tiny", seed=6)
    ref = JaxServer(JaxConfig(database_path=str(tmp / "jax.db"),
                              use_pallas_search=False, **_COMMON),
                    det_params=retinaface_init(jax.random.PRNGKey(0)),
                    rec_params=params, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp / "torch.db"),
                                    **_COMMON),
                      rec_params=params, warmup=False, device="cpu")
    yield ref, ours
    ours.close()


@contextlib.asynccontextmanager
async def _clients(servers):
    ref, ours = servers
    clients = [TestClient(TestServer(jax_make_app(ref))),
               TestClient(TestServer(make_app(ours)))]
    for c in clients:
        await c.start_server()
    try:
        yield clients
    finally:
        for c in clients:
            await c.close()


async def _ask(clients, method, path, **kw):
    """(status, body) from facekit's server and the port's."""
    out = []
    for c in clients:
        r = await getattr(c, method)(path, **kw)
        out.append((r.status, await r.text()))
    return out


async def _same(clients, method, path, **kw):
    ref, ours = await _ask(clients, method, path, **kw)
    assert ours == ref, (path, ours, ref)
    return ours[1]


async def _same_json(clients, method, path, sim_atol=1e-5, **kw):
    """JSON bodies equal, similarities within ``sim_atol``."""
    (rs, rb), (os_, ob) = await _ask(clients, method, path, **kw)
    assert rs == os_ == 200
    ref, ours = json.loads(rb), json.loads(ob)
    rows = (zip(ref["matches"], ours["matches"]) if "matches" in ref
            else [(ref, ours)])
    for r, o in rows:
        assert abs(r.pop("similarity") - o.pop("similarity")) < sim_atol
        assert o == r
    return json.loads(ob)


def _jpg(path, img):
    ok, buf = cv2.imencode(".jpg", img)
    path.write_bytes(buf.tobytes())
    return buf.tobytes()


async def test_responses_match_facekit(servers, tmp_path):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (112, 112, 3), dtype=np.uint8),
            rng.integers(0, 256, (112, 112, 3), dtype=np.uint8),
            rng.integers(0, 256, (120, 100, 3), dtype=np.uint8)]
    paths = [tmp_path / f"f{i}.jpg" for i in range(3)]
    data = [_jpg(p, im) for p, im in zip(paths, imgs)]
    fresh = _jpg(tmp_path / "fresh.jpg",
                 rng.integers(0, 256, (112, 112, 3), dtype=np.uint8))
    async with _clients(servers) as clients:
        for uid, name in (("morty", "Morty Smith"), ("rick", "Rick"),
                          ("summer", "Summer")):
            body = await _same(clients, "post", "/insert/user",
                               data=json.dumps({"userId": uid,
                                                "userName": name}))
            assert body == f"Success! User `{uid}` inserted.\n"
        await _same(clients, "post", "/insert/user", data=json.dumps(
            {"userId": "morty", "userName": "Morty Smith"}))
        await _same(clients, "post", "/insert/user", data="not json")
        # insert does not touch the live gallery: /recognize is "null"
        assert await _same(clients, "post", "/recognize", data=data[0]) \
            == "null"
        body = await _same(clients, "post", "/insert/face", data=json.dumps(
            {"data": [{"userId": u, "imgPath": str(p)}
                      for u, p in zip(("morty", "rick", "summer"), paths)]}))
        assert body.count("inserted successfully") == 3
        await _same(clients, "post", "/insert/face", data=json.dumps(
            {"data": [{"userId": "x", "imgPath": "/nonexistent.jpg"}]}))
        await _same(clients, "post", "/insert/face", data="{{{")
        await _same(clients, "post", "/insert/face",
                    data=json.dumps({"foo": 1}))
        await _same(clients, "post", "/insert/face",
                    data=b"\xff\xd8\xff\xe0junk")
        assert await _same(clients, "get", "/reload") == "Success\n"

        for d, uid in zip(data, ("morty", "rick", "summer")):
            got = await _same_json(clients, "post", "/recognize", data=d)
            assert got["userId"] == uid
        await _same_json(clients, "post", "/recognize", data=fresh)
        await _same(clients, "post", "/recognize", data=b"not an image")
        got = await _same_json(clients, "post", "/search?k=3", data=fresh)
        assert len(got["matches"]) == 3
        await _same(clients, "post", "/search?k=65", data=fresh)
        await _same(clients, "post", "/search?k=x", data=fresh)
        await _same(clients, "get", "/health")

        await _same(clients, "get", "/delete/face?id=1")
        await _same(clients, "get", "/delete/user?id=rick")
        await _same(clients, "get", "/delete/user")
        await _same(clients, "get", "/delete/face")
        await _same(clients, "get", "/reload")
        got = await _same_json(clients, "post", "/recognize", data=data[2])
        assert got["userId"] == "summer"
        await _same(clients, "get", "/health")
        _, ours = servers
        metrics = await (await clients[1].get("/metrics")).json()
        assert metrics["recognize"]["batches"] >= 1


def test_each_package_reads_the_others_database(servers):
    ref, ours = servers
    for path in (ref.config.database_path, ours.config.database_path):
        a_names, a_embs = JaxDatabase(path).get_embeddings()
        b_names, b_embs = Database(path).get_embeddings()
        assert a_names == b_names and len(a_names) > 0
        np.testing.assert_array_equal(a_embs, b_embs)
    j_names, j_embs = Database(ref.config.database_path).get_embeddings()
    t_names, t_embs = JaxDatabase(ours.config.database_path).get_embeddings()
    assert j_names == t_names
    np.testing.assert_allclose(t_embs, j_embs, atol=1e-5)


def test_recognize_batch_pads_to_buckets(servers):
    _, ours = servers
    crop = np.zeros((112, 112, 3), np.uint8)
    assert ours.pad_batch([crop] * 3).shape == (8, 112, 112, 3)
    out = ours.recognize_batch([crop] * 3)
    assert len(out) == 3 and all(set(o) == {"userId", "similarity"}
                                 for o in out)


@pytest.mark.parametrize("override", [
    {"api_imgIsCropped": False}, {"extras": {"rec_int8Residual": True}},
    {"mesh_shape": {"gallery": 4}},
    {"gen": True}, {"extras": {"server_enginesDir": "/tmp/engines"}},
    {"extras": {"server_hostOps": "native"}}])
def test_unported_configs_are_refused(override, tmp_path):
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"), **_COMMON)
    cfg = dataclasses.replace(cfg, **override)
    with pytest.raises(ValueError, match="not ported"):
        FaceServer(cfg, warmup=False, device="cpu")


@pytest.mark.parametrize("override", [{"rec_quantize": True},
                                      {"gallery_dtype": "int8"}])
def test_int8_configs_start(override, tmp_path):
    """The int8 embedder and the int8 gallery each serve on their own."""
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"), **_COMMON)
    server = FaceServer(dataclasses.replace(cfg, **override), warmup=True,
                        device="cpu")
    try:
        snap = server.gallery.snapshot()
        int8_gallery = override.get("gallery_dtype") == "int8"
        assert (snap.arr.dtype == torch.int8) == int8_gallery
        assert (snap.scales is not None) == int8_gallery
        assert server.pipeline.rec_net.int8 == (
            "dynamic" if override.get("rec_quantize") else None)
        crop = np.random.default_rng(0).integers(0, 256, (112, 112, 3),
                                                 dtype=np.uint8)
        emb = server.pipeline.embed_cropped(crop)
        server.gallery.add("a", emb)
        _, idx, names = server.gallery.search(emb[None], k=1)
        assert names[int(idx[0, 0])] == "a"
    finally:
        server.close()


def test_throughput_config_starts(tmp_path, monkeypatch, caplog):
    """configs/throughput.json on the CPU: batch buckets 1, 8 and 64, an
    int8 gallery at capacity 1,024 and the int8 IR-50. Its calibration
    folder (a relative path) is missing here, so the embedder keeps
    dynamic scales and says so."""
    cfg = load_config(os.path.join(REPO, "configs", "throughput.json"))
    cfg = dataclasses.replace(cfg, database_path=str(tmp_path / "t.db"))
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.WARNING, logger="facekit_torch.server"):
        server = FaceServer(cfg, warmup=False, device="cpu")
    try:
        assert server.batch_buckets == [1, 8, 64]
        assert server.gallery.capacity == 1024
        snap = server.gallery.snapshot()
        assert snap.arr.dtype == torch.int8 and snap.scales.shape == (1024,)
        assert server.pipeline.rec_net.int8 == "dynamic"
        assert not server.calibrated
        assert "int8 calibration skipped" in caplog.text
        assert server.pipeline.rec_net.blocks[0].conv1.q.dtype == torch.int8
    finally:
        server.close()


@pytest.fixture(scope="module")
def int8_servers(tmp_path_factory):
    import jax
    tmp = tmp_path_factory.mktemp("dbs8")
    params = random_arcface_params("ir_tiny", seed=7)
    extras = _INT8["extras"]
    common = {k: v for k, v in _INT8.items() if k != "extras"}
    ref = JaxServer(JaxConfig(database_path=str(tmp / "jax.db"),
                              use_pallas_search=False, extras=dict(extras),
                              **common),
                    det_params=retinaface_init(jax.random.PRNGKey(0)),
                    rec_params=params, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp / "torch.db"),
                                    extras=dict(extras), **common),
                      rec_params=params, warmup=False, device="cpu")
    yield ref, ours
    ours.close()


async def test_int8_responses_match_facekit(int8_servers, tmp_path):
    """The throughput profile's serving path (int8 embedder, int8 gallery,
    buckets 1/8/64) at ir_tiny in f32: bodies verbatim, userIds equal,
    similarities within INT8_SIM_ATOL, enrolled crops found as themselves."""
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
            for _ in range(3)]
    paths = [tmp_path / f"f{i}.jpg" for i in range(3)]
    data = [_jpg(p, im) for p, im in zip(paths, imgs)]
    fresh = _jpg(tmp_path / "fresh.jpg",
                 rng.integers(0, 256, (112, 112, 3), dtype=np.uint8))
    users = ("morty", "rick", "summer")
    _, ours = int8_servers
    async with _clients(int8_servers) as clients:
        for uid in users:
            await _same(clients, "post", "/insert/user",
                        data=json.dumps({"userId": uid, "userName": uid}))
        assert await _same(clients, "post", "/recognize", data=data[0]) \
            == "null"
        body = await _same(clients, "post", "/insert/face", data=json.dumps(
            {"data": [{"userId": u, "imgPath": str(p)}
                      for u, p in zip(users, paths)]}))
        assert body.count("inserted successfully") == 3
        assert await _same(clients, "get", "/reload") == "Success\n"
        for d, uid in zip(data, users):
            got = await _same_json(clients, "post", "/recognize",
                                   sim_atol=INT8_SIM_ATOL, data=d)
            assert got["userId"] == uid and got["similarity"] > 0.99
        await _same_json(clients, "post", "/recognize",
                         sim_atol=INT8_SIM_ATOL, data=fresh)
        got = await _same_json(clients, "post", "/search?k=3",
                               sim_atol=INT8_SIM_ATOL, data=fresh)
        assert len(got["matches"]) == 3
        await _same(clients, "get", "/health")
    assert ours.gallery.snapshot().arr.dtype == torch.int8
    # a batch the micro-batcher would pad to the 8 bucket
    out = ours.recognize_batch([imgs[0], imgs[1], imgs[2]])
    assert [o["userId"] for o in out] == list(users)


def test_int8_calibration_folder(tmp_path, caplog):
    """extras.rec_calibrationDir: a folder of crops calibrates the int8
    embedder at startup (static scales at every site); a missing folder
    warns and leaves the dynamic scales."""
    rng = np.random.default_rng(2)
    folder = tmp_path / "crops"
    folder.mkdir()
    for i in range(5):
        _jpg(folder / f"c{i}.jpg",
             rng.integers(0, 256, (120, 100, 3), dtype=np.uint8))
    (folder / "notes.txt").write_text("not an image")
    params = random_arcface_params("ir_tiny", seed=7)
    for calib_dir, calibrated in ((folder, True), (tmp_path / "none", False)):
        cfg = FaceKitConfig(database_path=str(tmp_path / "c.db"),
                            **dict(_INT8, extras={
                                "rec_calibrationDir": str(calib_dir),
                                "rec_calibrationHeadroom": 1.5}))
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="facekit_torch.server"):
            server = FaceServer(cfg, rec_params=params, warmup=False,
                                device="cpu")
        try:
            net = server.pipeline.rec_net
            assert server.calibrated == calibrated
            assert net.int8 == ("static" if calibrated else "dynamic")
            if calibrated:
                assert "calibrated from" in caplog.text
                assert all(b.conv1.ascale is not None and
                           b.conv2.ascale is not None for b in net.blocks)
            else:
                assert "int8 calibration skipped" in caplog.text
            emb = server.pipeline.embed_cropped(
                rng.integers(0, 256, (112, 112, 3), dtype=np.uint8))
            assert np.isfinite(emb).all()
            np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-5)
        finally:
            server.close()


def test_default_config_starts(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs", "default.json"))
    cfg = dataclasses.replace(cfg, database_path=str(tmp_path / "d.db"))
    server = FaceServer(cfg, warmup=False, device="cpu")
    try:
        assert server.batch_buckets == [1, 8]
        assert server.gallery.capacity == 1024
        assert server.gallery.snapshot().arr.dtype == torch.bfloat16
    finally:
        server.close()


def test_default_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"), **_COMMON)
    with pytest.raises(RuntimeError, match="cuda"):
        FaceServer(cfg, warmup=False)
    with pytest.raises(RuntimeError, match="cuda"):
        server_main(["--device", "cuda"])


def test_import_loads_no_jax_and_no_facekit():
    """In a fresh interpreter (this one has imported jax), importing every
    module of facekit_torch leaves jax and facekit out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import facekit_torch\n"
        "for m in pkgutil.walk_packages(facekit_torch.__path__, "
        "'facekit_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'facekit'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('facekit_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15
