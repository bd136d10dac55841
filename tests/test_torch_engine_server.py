"""A FaceServer booted from exported engines (``server_enginesDir`` /
``--engines``) against an eager server on the same params: WS
``/inference`` and ``/recognize`` replies equal, ``/reload`` works, and a
directory that does not fit the config refuses at startup.

ir_tiny, full-width RetinaFace at 120x160 frames and a 64x64 detector
input, batch buckets 1 and 2; the CLI exports the ladder once for the
module, with the random weights the server draws itself.
"""

import contextlib
import dataclasses
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from facekit_torch.config import FaceKitConfig
from facekit_torch.engine import export_identify_engines
from facekit_torch.engine import main as engine_main
from facekit_torch.parallel import make_mesh
from facekit_torch.pipeline import FacePipeline
from facekit_torch.server import FaceServer, make_app
from facekit_torch.server.app import model_params

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

_CFG = dict(rec_network="ir_tiny", compute_dtype="float32",
            gallery_dtype="float32", gallery_bucket_sizes=(16, 64),
            det_inputShape=(3, 64, 64), input_frameWidth=160,
            input_frameHeight=120, det_threshold_bbox=0.5,
            extras={"rec_useAlignment": True, "server_batchBuckets": [1, 2],
                    "server_wsPipeline": 2})
_FILES = ["embed.b1.fke", "embed.b2.fke", "recognize.b1.fke",
          "recognize.b2.fke"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The config's ladder exported by the CLI on the CPU."""
    tmp = tmp_path_factory.mktemp("engines")
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(_CFG))
    out = str(tmp / "out")
    engine_main(["export", "-c", str(cfg_path), "-o", out, "--device",
                 "cpu"])
    return out


def _config(tmp, name, **fields):
    return FaceKitConfig(**dict(_CFG, database_path=str(tmp / f"{name}.db"),
                                **fields))


def test_cli_writes_the_config_ladder(engines):
    """No ``-b``: one pair per bucket of ``server_batchBuckets``, with
    crops."""
    assert sorted(f for f in os.listdir(engines) if f.endswith(".fke")) \
        == _FILES
    for f in _FILES:
        meta = json.load(open(os.path.join(engines, f + ".json")))
        assert meta["device"] == "cpu"
        assert meta["batch_size"] == int(f.split(".b")[1][0])
        assert meta.get("return_crops", True)


@contextlib.asynccontextmanager
async def _clients(*servers):
    clients = [TestClient(TestServer(make_app(s))) for s in servers]
    for c in clients:
        await c.start_server()
    try:
        yield clients
    finally:
        for c in clients:
            await c.close()


async def _ws(client, jpgs):
    ws = await client.ws_connect("/inference")
    for j in jpgs:
        await ws.send_bytes(j)
    out = [(await ws.receive()).data for _ in jpgs]
    await ws.close()
    return out


def _jpg(img):
    return cv2.imencode(".jpg", img)[1].tobytes()


async def test_engine_server_answers_as_eager(engines, tmp_path):
    """WS /inference (two frames in flight, so buckets 1 and 2 both
    serve) and /recognize replies are equal, byte for byte, to an eager
    server's on the same params; after /reload too."""
    eager = FaceServer(_config(tmp_path, "eager"), warmup=False,
                       device="cpu")
    served = FaceServer(_config(tmp_path, "served"), warmup=True,
                        device="cpu", engines_dir=engines)
    assert served.engines is not None and eager.engines is None
    assert sorted(served.engines["recognize"]) == [1, 2]
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 120, 160, 3), dtype=np.uint8)
    crops = rng.integers(0, 256, (3, 112, 112, 3), dtype=np.uint8)
    jpgs = [_jpg(f) for f in frames]
    # users: a face of frame 0 (a slot that holds pixels) and a crop
    res = eager.pipeline.recognize_frames(np.stack(
        [eager.pixels.decode(j) for j in jpgs]), return_crops=True)
    slot = int(res.crops[0].std(dim=(1, 2, 3)).argmax())
    users = [("ann", res.embeddings[0, slot].numpy()),
             ("bob", eager.pipeline.embed_cropped(
                 eager.pixels.decode(_jpg(crops[1]))))]
    try:
        async with _clients(eager, served) as clients:
            for srv in (eager, served):
                for uid, emb in users[:1]:
                    srv.db.insert_user(uid, uid.title())
                    assert srv.db.insert_face(uid, f"{uid}.jpg", emb) == 1
            replies = []
            for c in clients:
                assert (await c.get("/reload")).status == 200
                ws = await _ws(c, jpgs)
                rec = [await (await c.post("/recognize",
                                           data=_jpg(x))).text()
                       for x in crops]
                replies.append((ws, rec))
            # a second user, served after /reload
            for srv in (eager, served):
                for uid, emb in users[1:]:
                    srv.db.insert_user(uid, uid.title())
                    assert srv.db.insert_face(uid, f"{uid}.jpg", emb) == 1
            for c, r in zip(clients, replies):
                assert (await c.get("/reload")).status == 200
                r[1].append(await (await c.post(
                    "/recognize", data=_jpg(crops[1]))).text())
    finally:
        eager.close()
        served.close()
    assert replies[1] == replies[0]
    ws, rec = replies[1]
    assert json.loads(ws[0])["userId"] == "ann"
    assert all(json.loads(t)["image"] for t in ws)
    assert json.loads(rec[-1])["userId"] == "bob"
    assert json.loads(rec[-1])["similarity"] > 0.99


def test_missing_bucket_refuses(engines, tmp_path):
    """``extras.server_enginesDir`` names the directory as the argument
    does; a bucket of the ladder without its pair refuses."""
    extras = dict(_CFG["extras"], server_batchBuckets=[1, 2, 4],
                  server_enginesDir=engines)
    with pytest.raises(ValueError, match=r"bucket\(s\) \[4\].*-b 1,2,4"):
        FaceServer(_config(tmp_path, "x", extras=extras), warmup=False,
                   device="cpu")


def test_no_crops_and_stale_engines_refuse(engines, tmp_path):
    """An artifact without crops, and one of another threshold, refuse at
    startup with the re-export hint."""
    dst = str(tmp_path / "e")
    shutil.copytree(engines, dst)
    side = os.path.join(dst, "recognize.b2.fke.json")
    meta = json.load(open(side))
    json.dump(dict(meta, return_crops=False), open(side, "w"))
    with pytest.raises(ValueError, match="--no-crops"):
        FaceServer(_config(tmp_path, "x"), warmup=False, device="cpu",
                   engines_dir=dst)
    with pytest.raises(ValueError, match="det_threshold_bbox"):
        FaceServer(_config(tmp_path, "y", det_threshold_bbox=0.55),
                   warmup=False, device="cpu", engines_dir=engines)


def test_mesh_shape_with_engines_still_refuses(engines, tmp_path):
    """A mesh served from engines takes identify engines: with only the
    recognize / embed pairs in the directory it refuses, naming the
    missing bucket and the export that makes it; with an identify engine
    added, it boots from it (warmed) and answers WS /inference's batch
    function. The mesh has 2 positions and the ladder one bucket, so
    one identify engine is exported."""
    cfg = dataclasses.replace(
        _config(tmp_path, "x", extras=dict(_CFG["extras"],
                                           server_batchBuckets=[2])),
        mesh_shape={"gallery": 2})
    with pytest.raises(ValueError, match=r"no identify engine for batch "
                       r"bucket\(s\) \[2\].*--identify-mesh gallery=2"):
        FaceServer(cfg, warmup=False, device="cpu", engines_dir=engines)
    dst = str(tmp_path / "e")
    shutil.copytree(engines, dst)
    pipe = FacePipeline(cfg, *model_params(cfg), device="cpu")
    export_identify_engines(pipe, dst, [2], 64, make_mesh(
        cfg.mesh_shape, devices=["cpu"] * 2))
    server = FaceServer(cfg, warmup=True, device="cpu", engines_dir=dst)
    try:
        assert sorted(server.identify_engines) == server.batch_buckets == [2]
        assert server.engines is None and server.gallery.buckets == (64,)
        frames = np.random.default_rng(5).integers(0, 256, (2, 120, 160, 3),
                                                   dtype=np.uint8)
        emb = server.pipeline.recognize_frames(frames).embeddings[0, 0]
        server.gallery.load(["ann"], emb[None].numpy())
        assert server.inference_batch(list(frames))[0]["userId"] == "ann"
    finally:
        server.close()


def test_cli_exports_the_slim_detector(tmp_path):
    """``det_network: slim`` through the CLI at one batch (the bare
    names), and a server of that config boots from the result."""
    cfg = dict(_CFG, det_network="slim", extras={"rec_useAlignment": True})
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    out = str(tmp_path / "out")
    engine_main(["export", "-c", str(tmp_path / "cfg.json"), "-o", out,
                 "-b", "2", "--device", "cpu"])
    assert sorted(f for f in os.listdir(out) if f.endswith(".fke")) == [
        "embed.fke", "recognize.fke"]
    meta = json.load(open(os.path.join(out, "recognize.fke.json")))
    assert meta["det_network"] == "slim" and meta["with_landmarks"]
    server = FaceServer(FaceKitConfig(**dict(
        cfg, database_path=str(tmp_path / "s.db"),
        extras={"rec_useAlignment": True, "server_batchSize": 2})),
        warmup=True, device="cpu", engines_dir=out)
    server.close()
