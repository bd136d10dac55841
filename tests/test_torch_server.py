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
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params)

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
    # a mesh served from engines takes identify engines since they were
    # ported (tests/test_torch_identify_engine.py): a directory without
    # them refuses with the export that makes them, not as unported
    {"mesh_shape": {"gallery": 4},
     "extras": {"server_enginesDir": "engines"}},
    {"extras": {"profiler_port": 9999}}])
def test_unported_configs_are_refused(override, tmp_path):
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"), **_COMMON)
    cfg = dataclasses.replace(cfg, **override)
    if not cfg.mesh_shape:
        with pytest.raises(ValueError, match="not ported"):
            FaceServer(cfg, warmup=False, device="cpu")
        return
    engines = tmp_path / cfg.extras["server_enginesDir"]
    engines.mkdir()
    for kw in ({"extras": {"server_enginesDir": str(engines)}},
               {"extras": {}}):
        with pytest.raises(ValueError, match=r"no identify engine for "
                           r"batch bucket\(s\) \[8\].*--identify-mesh "
                           "gallery=4"):
            FaceServer(dataclasses.replace(cfg, **kw), warmup=False,
                       device="cpu",
                       engines_dir=None if kw["extras"] else str(engines))


@pytest.mark.parametrize("mesh_shape", [{"gallery": 4}, {"data": 2}])
def test_mesh_configs_start(mesh_shape, tmp_path):
    """A mesh alone serves eagerly (tests/test_torch_mesh_server.py holds
    it to facekit's mesh server): on the CPU every position is the CPU."""
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"),
                        mesh_shape=mesh_shape, **_COMMON)
    server = FaceServer(cfg, warmup=False, device="cpu")
    try:
        assert server.mesh.shape == {"gallery": 1, **mesh_shape}
        assert server.gallery.mesh is server.mesh
        assert len(server.gallery.snapshot().arr.blocks) == \
            server.mesh.shape["gallery"]
        assert all(b % mesh_shape.get("data", 1) == 0
                   for b in server.batch_buckets)
    finally:
        server.close()


# facekit's refusal (facekit/server/app.py:177-188): the residual flag is
# read by the calibration only, so without one it would be ignored
_RESIDUAL_REFUSAL = "rec_int8Residual requires rec_quantize AND " \
    "rec_calibrationDir"


@pytest.mark.parametrize("override", [
    {"extras": {"rec_int8Residual": True}},
    {"rec_quantize": True, "extras": {"rec_int8Residual": True}},
    {"rec_quantize": False, "extras": {"rec_int8Residual": True,
                                       "rec_calibrationDir": "/tmp"}}])
def test_int8_residual_without_calibration_is_refused(override, tmp_path):
    cfg = dataclasses.replace(FaceKitConfig(
        database_path=str(tmp_path / "x.db"), **_COMMON), **override)
    with pytest.raises(ValueError, match=_RESIDUAL_REFUSAL):
        FaceServer(cfg, warmup=False, device="cpu")
    with pytest.raises(ValueError, match=_RESIDUAL_REFUSAL):
        JaxServer(JaxConfig(database_path=str(tmp_path / "j.db"),
                            **{**_COMMON, **override}), warmup=False)


def test_native_host_ops_config_starts(tmp_path):
    """``server_hostOps: "native"`` serves on the port's own native
    runtime (tests/test_torch_native.py holds it to the cv2 server)."""
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"),
                        extras={"server_hostOps": "native"}, **_COMMON)
    server = FaceServer(cfg, warmup=True, device="cpu")
    try:
        assert server.pixels.name == "native"
        crop = cv2.imencode(".jpg", np.full((112, 112, 3), 77, np.uint8))[1]
        assert server.pixels.decode(crop.tobytes()).shape == (112, 112, 3)
    finally:
        server.close()


def test_int8_residual_server_serves(tmp_path):
    """``rec_quantize`` + ``rec_calibrationDir`` + ``rec_int8Residual``:
    the server calibrates into the residual embedder and recognizes an
    enrolled crop; a calibration folder with no image refuses to start
    instead of degrading to dynamic scales, as facekit's does."""
    rng = np.random.default_rng(12)
    folder = tmp_path / "crops"
    folder.mkdir()
    crops = rng.integers(0, 256, (4, 112, 112, 3), dtype=np.uint8)
    for i, c in enumerate(crops):
        _jpg(folder / f"c{i}.jpg", c)
    cfg = FaceKitConfig(database_path=str(tmp_path / "r.db"),
                        **dict(_INT8, extras={
                            "rec_calibrationDir": str(folder),
                            "rec_int8Residual": True}))
    server = FaceServer(cfg, rec_params=random_arcface_params("ir_tiny",
                                                              seed=7),
                        warmup=True, device="cpu")
    try:
        assert server.calibrated and server.pipeline.rec_net.int8 == \
            "residual"
        for i, c in enumerate(crops):
            server.db.insert_user(f"u{i}", f"U{i}")
            server.db.insert_face(f"u{i}", f"c{i}.jpg",
                                  server.pipeline.embed_cropped(c))
        server.reload_gallery()
        out = server.recognize_batch([crops[2], crops[0]])
        assert [o["userId"] for o in out] == ["u2", "u0"]
        assert min(o["similarity"] for o in out) > 0.99
    finally:
        server.close()
    empty = tmp_path / "empty"
    empty.mkdir()
    bad = dataclasses.replace(cfg, extras={"rec_calibrationDir": str(empty),
                                           "rec_int8Residual": True})
    with pytest.raises(ValueError, match="no readable calibration images"):
        FaceServer(bad, warmup=False, device="cpu")


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


def test_import_loads_no_jax_and_no_facekit(tmp_path):
    """In a fresh interpreter (this one has imported jax), importing every
    module of facekit_torch (the CLIs' ``__main__`` modules too, which run
    nothing on import; ``facekit_torch.engine``, ``facekit_torch.train``
    and ``facekit_torch.parallel`` among them), then exporting,
    saving, loading and calling an engine, leaves jax and facekit out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import facekit_torch\n"
        "for m in pkgutil.walk_packages(facekit_torch.__path__, "
        "'facekit_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'facekit_torch.engine' in sys.modules\n"
        "assert 'facekit_torch.train.checkpoint' in sys.modules\n"
        "assert 'facekit_torch.parallel.sharded_search' in sys.modules\n"
        "import torch\n"
        "from facekit_torch.config import FaceKitConfig\n"
        "from facekit_torch.engine import (engine_states, "
        "export_embed_engine, load_engine, save_engine)\n"
        "from facekit_torch.pipeline import FacePipeline\n"
        "from facekit_torch.weights import random_arcface_params\n"
        "pipe = FacePipeline(FaceKitConfig(rec_network='ir_tiny', "
        "compute_dtype='float32'), random_arcface_params('ir_tiny'), "
        "device='cpu')\n"
        f"path = {str(tmp_path / 'embed.fke')!r}\n"
        "save_engine(path, *export_embed_engine(pipe, 1))\n"
        "fn, _ = load_engine(path, 'cpu')\n"
        "emb = fn(engine_states(pipe)[1], torch.zeros((1, 112, 112, 3), "
        "dtype=torch.uint8))\n"
        "assert emb.shape == (1, 512)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'facekit'))\n"
        "assert not bad, bad\n"
        "assert 'facekit_torch.models.lightdet' in sys.modules\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('facekit_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15


# -- detection on the server: WS /inference, /insert/face uncropped -------------

# random detector weights score every anchor of any frame near 0.5 (the
# letterbox's constant pad rows score highest), so a threshold of 0.5
# finds det_maxFacesPerScene faces in every frame and 0.99 finds none
_DET = dict(_COMMON, api_imgIsCropped=False, det_threshold_bbox=0.5)


def _det_servers(tmp, det_override=None, extras=None):
    """facekit's server and the port's on one config, one numpy-drawn
    embedder and detector."""
    rp = random_arcface_params("ir_tiny", seed=8)
    dp = random_retinaface_params(seed=0)
    cfg = dict(_DET, extras=dict({"rec_useAlignment": True}, **(extras or {})),
               **(det_override or {}))
    ref = JaxServer(JaxConfig(database_path=str(tmp / "jax.db"),
                              use_pallas_search=False, **cfg),
                    det_params=dp, rec_params=rp, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp / "torch.db"),
                                    **cfg),
                      rec_params=rp, det_params=dp, warmup=False,
                      device="cpu")
    return ref, ours


def _enroll(servers, users):
    """Write the same (userId, embedding) rows into both databases."""
    for srv in servers:
        for uid, emb in users:
            srv.db.insert_user(uid, uid.title())
            assert srv.db.insert_face(uid, f"{uid}.jpg", emb) == 1


async def _ws_replies(client, frames):
    """Send every frame on one socket before reading, then read as many
    replies (they come back in message order)."""
    ws = await client.ws_connect("/inference")
    for f in frames:
        await ws.send_bytes(f)
    out = [(await ws.receive()).data for _ in frames]
    await ws.close()
    return out


def _decode(b64):
    import base64
    return cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8),
                        cv2.IMREAD_COLOR)


async def test_ws_inference_matches_facekit(tmp_path):
    """WS /inference with two frames in flight per socket: "null" while
    the gallery is empty and for an undecodable frame; otherwise userId,
    userName and isUnknown equal, similarity within 1e-4, and the best
    face's decoded JPEG crop within 2 LSB of facekit's on 99.9% of its
    pixels (either side truncates f32 crops that differ in the 4th decimal
    to uint8, and JPEG spreads a 1-LSB flip over its 8x8 block)."""
    servers = _det_servers(tmp_path, extras={"server_wsPipeline": 2})
    ref, ours = servers
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
              for _ in range(3)]
    jpgs = [_jpg(tmp_path / f"w{i}.jpg", f) for i, f in enumerate(frames)]
    try:
        async with _clients(servers) as clients:
            for c in clients:
                assert await _ws_replies(c, jpgs[:2]) == ["null", "null"]
            # users: a face of frame 0, a face of frame 2, and a stranger.
            # Slots 0 and 2 of these frames are degenerate boxes on the
            # bottom edge whose crops are all zero, so they embed alike in
            # every frame; the users come from slots that hold pixels.
            decoded = [ours.pixels.decode(j) for j in jpgs]
            res = ours.pipeline.recognize_frames(np.stack(decoded),
                                                 return_crops=True)
            assert res.crops[0, 1].std() > 10 and res.crops[2, 3].std() > 10
            emb = res.embeddings
            stranger = rng.normal(size=512).astype(np.float32)
            _enroll(servers, [("ann", emb[0, 1].numpy()),
                              ("bob", emb[2, 3].numpy()),
                              ("cy", stranger / np.linalg.norm(stranger))])
            await _same(clients, "get", "/reload")
            sent = jpgs + [b"not an image", jpgs[0]]
            got = [await _ws_replies(c, sent) for c in clients]
            metrics = await (await clients[1].get("/metrics")).json()
    finally:
        ours.close()
    assert metrics["inference"]["batches"] >= 1
    assert got[0][3] == got[1][3] == "null"
    for r_txt, o_txt in zip(got[0], got[1]):
        if r_txt == "null":
            assert o_txt == "null"
            continue
        r, o = json.loads(r_txt), json.loads(o_txt)
        assert list(o) == list(r)
        for key in ("userId", "userName", "isUnknown"):
            assert o[key] == r[key]
        assert abs(o["similarity"] - r["similarity"]) < 1e-4
        ri, oi = _decode(r["image"]), _decode(o["image"])
        assert oi.shape == ri.shape == (112, 112, 3)
        diff = np.abs(oi.astype(int) - ri.astype(int))
        assert (diff <= 2).mean() >= 0.999, diff.max()
    users = [json.loads(t)["userId"] for t in got[1] if t != "null"]
    assert users[0] == users[3] == "ann" and users[2] == "bob"


@pytest.mark.parametrize("det_override,expected", [
    ({}, "There are more than 1 faces in input image"),
    ({"det_maxFacesPerScene": 1}, "1 face found in input image"),
    ({"det_threshold_bbox": 0.99}, "Cant find any faces in input image")])
async def test_insert_face_uncropped_matches_facekit(tmp_path, det_override,
                                                     expected):
    """``api_imgIsCropped: false``: /insert/face runs the detector on the
    whole image and enrolls exactly one face; more than one face and none
    fail with facekit's strings, verbatim. A frame without a face answers
    WS /inference with "null" on both servers."""
    servers = _det_servers(tmp_path, det_override)
    ref, ours = servers
    img = np.random.default_rng(13).integers(0, 256, (300, 400, 3),
                                              dtype=np.uint8)
    path = tmp_path / "face.jpg"
    data = _jpg(path, img)
    try:
        async with _clients(servers) as clients:
            await _same(clients, "post", "/insert/user", data=json.dumps(
                {"userId": "dan", "userName": "Dan"}))
            body = await _same(clients, "post", "/insert/face",
                               data=json.dumps({"data": [
                                   {"userId": "dan", "imgPath": str(path)}]}))
            assert body.startswith(expected), body
            assert ("inserted successfully" in body) == \
                expected.startswith("1 face")
            if "Cant find" in expected:
                _enroll(servers, [("eve", np.eye(512, dtype=np.float32)[0])])
                await _same(clients, "get", "/reload")
                got = [await _ws_replies(c, [data]) for c in clients]
                assert got == [["null"], ["null"]]
    finally:
        ours.close()
    names, embs = Database(ours.config.database_path).get_embeddings()
    r_names, r_embs = JaxDatabase(ref.config.database_path).get_embeddings()
    assert names == r_names
    np.testing.assert_allclose(embs, r_embs, atol=1e-4)


def _det_file(tmp, with_landmarks):
    """A RetinaFace param file written by facekit's ``save_params``."""
    from facekit.weights import save_params
    path = str(tmp / "det.msgpack")
    save_params(random_retinaface_params(seed=0,
                                         with_landmarks=with_landmarks), path)
    return path


@pytest.mark.parametrize("override", [
    {"det_network": "slim"}, {"det_network": "rfb"}, {"det_quantize": True}])
async def test_detector_configs_serve_ws_inference(override, tmp_path):
    """The slim and RFB detectors and the int8 detector, once refused at
    startup: a server on the CPU with each draws its random detector from
    ``det_network`` and answers one WS /inference batch with the face it
    enrolled from the same frame."""
    cfg = FaceKitConfig(database_path=str(tmp_path / "d.db"),
                        **dict(_DET, **override))
    server = FaceServer(cfg, rec_params=random_arcface_params("ir_tiny",
                                                             seed=8),
                        warmup=False, device="cpu")
    try:
        det = server.pipeline.det_net
        assert type(det).__name__ == ("LightDet" if "det_network" in override
                                      else "RetinaFace")
        assert server.pipeline.use_landmarks
        assert any(type(m).__name__ == "QConv" for m in det.modules()) == \
            bool(override.get("det_quantize"))
        frame = np.random.default_rng(16).integers(0, 256, (480, 640, 3),
                                                   dtype=np.uint8)
        data = _jpg(tmp_path / "f.jpg", frame)
        res = server.pipeline.recognize_frame(server.pixels.decode(data),
                                              return_crops=True)
        slot = int(res.crops.std(dim=(1, 2, 3)).masked_fill(
            ~res.valid, -1.0).argmax())
        assert res.valid[slot] and res.crops[slot].std() > 10
        _enroll([server], [("gus", res.embeddings[slot].numpy())])
        server.reload_gallery()
        client = TestClient(TestServer(make_app(server)))
        await client.start_server()
        try:
            reply = json.loads((await _ws_replies(client, [data]))[0])
        finally:
            await client.close()
    finally:
        server.close()
    assert reply["userId"] == "gus" and reply["similarity"] > 0.999
    assert _decode(reply["image"]).shape == (112, 112, 3)


def test_det_weights_without_landmarks_flag_drop_the_head(tmp_path):
    """``det_withLandmarks: false`` with a detector file that holds a
    landmark head: facekit restores the file into a template without one,
    so both servers run without landmarks and crop-resize the boxes
    unaligned, with the same crops and embeddings."""
    cfg = dict(_DET, det_weights=_det_file(tmp_path, True),
               det_withLandmarks=False, extras={"rec_useAlignment": True})
    rp = random_arcface_params("ir_tiny", seed=8)
    ref = JaxServer(JaxConfig(database_path=str(tmp_path / "jax.db"),
                              use_pallas_search=False, **cfg),
                    rec_params=rp, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp_path / "t.db"),
                                    **cfg),
                      rec_params=rp, warmup=False, device="cpu")
    try:
        assert not ref.pipeline.use_landmarks and not ref.pipeline.align
        assert not ours.pipeline.use_landmarks and not ours.pipeline.align
        assert ours.pipeline.det_net.ldm_head is None
        frames = np.random.default_rng(15).integers(0, 256, (2, 480, 640, 3),
                                                    dtype=np.uint8)
        res = ours.pipeline.recognize_frames(frames, return_crops=True)
        r_res = ref.pipeline.recognize_frames(frames, return_crops=True)
    finally:
        ours.close()
    assert res.landmarks is None and r_res.landmarks is None
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(r_res.valid))
    assert res.valid.all()
    np.testing.assert_allclose(res.boxes.numpy(), np.asarray(r_res.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(res.crops.numpy(), np.asarray(r_res.crops),
                               atol=1)
    np.testing.assert_allclose(res.embeddings.numpy(),
                               np.asarray(r_res.embeddings), atol=1e-4)


def test_det_weights_without_head_refuse_landmarks(tmp_path):
    """``det_withLandmarks: true`` with a detector file that has no
    landmark head: facekit's restore raises, and the port refuses to
    start."""
    from facekit.models import init_model_params
    cfg = dict(_DET, det_weights=_det_file(tmp_path, False),
               det_withLandmarks=True)
    with pytest.raises(ValueError):
        init_model_params(JaxConfig(**cfg))
    with pytest.raises(ValueError, match="no ldm_head"):
        FaceServer(FaceKitConfig(database_path=str(tmp_path / "t.db"), **cfg),
                   warmup=False, device="cpu")


def test_inference_batch_pads_and_picks_the_best_face(tmp_path):
    """The WS batcher's function: frames padded to the batch bucket, one
    reply per frame with the best valid face's uint8 crop."""
    _, ours = _det_servers(tmp_path)
    try:
        frames = list(np.random.default_rng(14).integers(
            0, 256, (3, 480, 640, 3), dtype=np.uint8))
        assert ours.inference_batch(frames) == [None] * 3    # empty gallery
        emb = ours.pipeline.recognize_frame(frames[1]).embeddings[3]
        _enroll([ours], [("fay", emb.numpy())])
        ours.reload_gallery()
        outs = ours.inference_batch(frames)
        assert ours.pad_batch(frames).shape == (8, 480, 640, 3)
        assert outs[1]["userId"] == "fay" and outs[1]["similarity"] > 0.999
        assert not outs[1]["isUnknown"]
        for o in outs:
            assert o["crop"].dtype == np.uint8
            assert o["crop"].shape == (112, 112, 3)
    finally:
        ours.close()
