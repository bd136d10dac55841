"""facekit_torch's FaceServer with ``mesh_shape`` against facekit's.

The port's counterparts of tests/test_server.py's mesh tests: one
process serves a mesh whose every position is the CPU (facekit's: 8
virtual XLA CPU devices), with the same numpy-drawn slim detector and
ir_tiny embedder as facekit's server. /recognize, /search and WS
/inference must name the same users with similarities within 1e-5
(within INT8_SIM_ATOL for the int8 embedder); the gallery shards over
"gallery"; the batch buckets round up to multiples of "data".
"""

import json

import cv2
import numpy as np
import pytest

from facekit.config import FaceKitConfig as JaxConfig
from facekit.server import FaceServer as JaxServer
from facekit_torch.config import FaceKitConfig
from facekit_torch.models import detector_family
from facekit_torch.server import FaceServer, make_app
from facekit_torch.weights import random_arcface_params
from test_torch_server import (INT8_SIM_ATOL, _clients, _jpg, _same,
                               _same_json, _ws_replies)

pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

# slim + ir_tiny at 160x120 frames: random slim weights find faces at 0.3
_TINY = dict(det_network="slim", rec_network="ir_tiny",
             det_inputShape=(3, 64, 64), input_frameWidth=160,
             input_frameHeight=120, compute_dtype="float32",
             gallery_dtype="float32", det_threshold_bbox=0.3,
             gallery_bucket_sizes=(16, 64))
MESHES = {"gallery8": {"gallery": 8}, "data2_gallery4": {"data": 2,
                                                         "gallery": 4},
          "data2": {"data": 2}}


def _servers(tmp_path, **cfg):
    """facekit's server and the port's on one config and one set of
    numpy-drawn weights."""
    cfg = dict(_TINY, **cfg)
    rp = random_arcface_params("ir_tiny", seed=5)
    dp = detector_family("slim").random_params(0, True)
    ref = JaxServer(JaxConfig(database_path=str(tmp_path / "jax.db"),
                              use_pallas_search=False, **cfg),
                    det_params=dp, rec_params=rp, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp_path / "t.db"),
                                    **cfg),
                      rec_params=rp, det_params=dp, warmup=False,
                      device="cpu")
    return ref, ours


@pytest.mark.parametrize("mesh", sorted(MESHES))
async def test_mesh_server_matches_facekit(tmp_path, mesh):
    """Enrollment through /insert/face and /reload, then /recognize,
    /search and WS /inference (two frames in flight) on a mesh: the same
    replies as facekit's mesh server."""
    shape = MESHES[mesh]
    servers = _servers(tmp_path, mesh_shape=shape,
                       extras={"server_batchSize": 4, "server_wsPipeline": 2})
    ref, ours = servers
    assert ours.mesh.shape == dict(ref.mesh.shape) == {"gallery": 1, **shape}
    assert ours.batch_buckets == ref.batch_buckets == [4]
    rng = np.random.default_rng(29)
    crops = [_jpg(tmp_path / f"c{i}.jpg",
                  rng.integers(0, 256, (112, 112, 3), dtype=np.uint8))
             for i in range(3)]
    frames = [_jpg(tmp_path / f"f{i}.jpg",
                   rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
              for i in range(2)]
    try:
        async with _clients(servers) as clients:
            for i, uid in enumerate(("ann", "bob", "cy")):
                await _same(clients, "post", "/insert/user", data=json.dumps(
                    {"userId": uid, "userName": uid.title()}))
                await _same(clients, "post", "/insert/face", data=json.dumps(
                    {"data": [{"userId": uid,
                               "imgPath": str(tmp_path / f"c{i}.jpg")}]}))
            assert await _same(clients, "get", "/reload") == "Success\n"
            arr = ours.gallery.snapshot().arr
            assert len(arr.blocks) == ours.mesh.shape["gallery"]
            for data, uid in zip(crops, ("ann", "bob", "cy")):
                got = await _same_json(clients, "post", "/recognize",
                                       data=data)
                assert got["userId"] == uid and got["similarity"] > 0.99
            got = await _same_json(clients, "post", "/search?k=2",
                                   data=crops[1])
            assert got["matches"][0]["userId"] == "bob"
            await _same(clients, "get", "/health")
            replies = [await _ws_replies(c, frames) for c in clients]
    finally:
        ours.close()
    for r_txt, o_txt in zip(*replies):
        assert (r_txt == "null") == (o_txt == "null")
        if r_txt == "null":
            continue
        r, o = json.loads(r_txt), json.loads(o_txt)
        for key in ("userId", "userName", "isUnknown"):
            assert o[key] == r[key]
        assert abs(o["similarity"] - r["similarity"]) < 1e-4
    assert any(t != "null" for t in replies[1])


async def test_mesh_server_int8_gallery(tmp_path):
    """mesh x int8 gallery: rows and scales sharded 8 ways, /recognize as
    facekit's."""
    servers = _servers(tmp_path, gallery_dtype="int8",
                       mesh_shape={"gallery": 8})
    ref, ours = servers
    data = _jpg(tmp_path / "q.jpg", np.random.default_rng(31).integers(
        0, 256, (112, 112, 3), dtype=np.uint8))
    try:
        async with _clients(servers) as clients:
            await _same(clients, "post", "/insert/user", data=json.dumps(
                {"userId": "mq", "userName": "MQ"}))
            await _same(clients, "post", "/insert/face", data=json.dumps(
                {"data": [{"userId": "mq", "imgPath": str(tmp_path /
                                                         "q.jpg")}]}))
            await _same(clients, "get", "/reload")
            snap = ours.gallery.snapshot()
            assert ours.gallery.quantized and len(snap.scales.blocks) == 8
            got = await _same_json(clients, "post", "/recognize", data=data)
            assert got["userId"] == "mq" and got["similarity"] > 0.95
    finally:
        ours.close()


async def test_mesh_server_quantized_embedder(tmp_path):
    """The whole low-precision serving point on a mesh: the int8 embedder
    (rec_quantize), an int8 gallery sharded over "gallery" and batches
    split over "data", through /recognize, against the port's
    single-device server on the same weights (which
    tests/test_torch_server.py holds to facekit's int8 server): the same
    bodies, similarities within INT8_SIM_ATOL."""
    cfg = dict(_TINY, gallery_dtype="int8", rec_quantize=True,
               extras={"server_batchSize": 2})
    rp = random_arcface_params("ir_tiny", seed=5)
    servers = [FaceServer(FaceKitConfig(
        database_path=str(tmp_path / f"{i}.db"), mesh_shape=mesh, **cfg),
        rec_params=rp, warmup=False, device="cpu")
        for i, mesh in enumerate((None, {"data": 2, "gallery": 4}))]
    rng = np.random.default_rng(37)
    crops = rng.integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    jpgs = [_jpg(tmp_path / f"q{i}.jpg", c) for i, c in enumerate(crops)]
    decoded = [cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR)
               for j in jpgs]
    try:
        assert servers[1].gallery.quantized and servers[1].mesh is not None
        # enroll each server's own int8 embedding of the decoded crops
        for srv in servers:
            srv.gallery.load(["fi", "fj"], np.stack(
                [srv.pipeline.embed_cropped(d) for d in decoded]))
        clients = [TestClient(TestServer(make_app(srv))) for srv in servers]
        for c in clients:
            await c.start_server()
        try:
            for data, uid in zip(jpgs, ("fi", "fj")):
                got = await _same_json(clients, "post", "/recognize",
                                       data=data, sim_atol=INT8_SIM_ATOL)
                assert got["userId"] == uid and got["similarity"] > 0.9
        finally:
            for c in clients:
                await c.close()
    finally:
        for srv in servers:
            srv.close()


async def test_mesh_with_bucket_ladder(tmp_path):
    """server_batchBuckets [1, 3] on a data axis of 2 round to [2, 4], as
    facekit's; a lone request dispatches the small bucket."""
    servers = _servers(tmp_path, mesh_shape={"data": 2, "gallery": 4},
                       extras={"server_batchSize": 4,
                               "server_batchBuckets": [1, 3]})
    ref, ours = servers
    assert ours.batch_buckets == ref.batch_buckets == [2, 4]
    assert ours.batch_size == 4
    emb = np.random.default_rng(41).normal(size=(2, 512)).astype(np.float32)
    ours.gallery.load(["ma", "mb"], emb / np.linalg.norm(emb, axis=1,
                                                          keepdims=True))
    dispatched = []
    orig = ours.pipeline.embed_and_match

    def spy(crops, *a, **k):
        dispatched.append(crops.shape[0])
        return orig(crops, *a, **k)

    ours.pipeline.embed_and_match = spy
    client = TestClient(TestServer(make_app(ours)))
    await client.start_server()
    try:
        r = await client.post("/recognize", data=_jpg(
            tmp_path / "x.jpg", np.zeros((112, 112, 3), np.uint8)))
        assert json.loads(await r.text())["userId"] in ("ma", "mb")
    finally:
        await client.close()
        ours.close()
    assert dispatched == [2]
