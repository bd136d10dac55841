"""facekit_torch's identify engines: the whole WS /inference transaction
(detect -> align -> embed -> gallery match) exported as one program over
a device mesh, against the port's eager mesh pipeline (bit for bit) and
facekit's mesh ``recognize_and_match``; their refusals; a mesh server
booted from them. The port's counterparts of
``tests/test_engine_identify.py``.

The mesh puts torch's one CPU device at the 4 positions of
``{"data": 2, "gallery": 2}`` (facekit's: 8 virtual XLA CPU devices as
``{"data": 2, "gallery": 4}``). slim + ir_tiny at 160x120 frames, f32,
top 2, a 64-row gallery (32 rows a shard); the CLI exports the f32
ladder once for the module with the random weights a server of the
config draws itself.
"""

import contextlib
import json
import os
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.ops.similarity import quantize_rows_int8 as jax_quantize
from facekit.parallel import make_mesh as jax_make_mesh
from facekit.parallel import shard_gallery as jax_shard_gallery
from facekit.parallel import shard_rows as jax_shard_rows
from facekit.pipeline import FacePipeline as JaxPipeline
from facekit_torch.config import FaceKitConfig
from facekit_torch.engine import (IdentifyEngine, device_map,
                                  export_identify_engine,
                                  load_identify_engines, main)
from facekit_torch.ops.similarity import quantize_rows_int8
from facekit_torch.parallel import make_mesh, shard_gallery, shard_rows
from facekit_torch.pipeline import FacePipeline
from facekit_torch.server import FaceServer, make_app
from facekit_torch.server.app import model_params

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

B = 2
ROWS = 64
MESH = {"data": 2, "gallery": 2}
_CFG = dict(det_network="slim", rec_network="ir_tiny",
            det_inputShape=(3, 64, 64), input_frameWidth=160,
            input_frameHeight=120, compute_dtype="float32",
            gallery_dtype="float32", det_threshold_bbox=0.3, gallery_topk=2,
            gallery_bucket_sizes=(ROWS,), extras={"server_batchSize": B})
# an int8 search quantizes the queries: a rounding difference of an
# embedding can move one query component by a step (amax / 127)
INT8_SIM_ATOL = 1e-3


def _config(**fields):
    return FaceKitConfig(**dict(_CFG, **fields))


def _unit(rng, n):
    x = rng.normal(size=(n, 512)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _frames(seed, n=B):
    return np.random.default_rng(seed).integers(0, 256, (n, 120, 160, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """``python -m facekit_torch.engine export --identify-mesh
    data=2,gallery=2 --gallery-rows 64 --device cpu`` of the config."""
    tmp = tmp_path_factory.mktemp("identify")
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps(_CFG))
    out = str(tmp / "out")
    main(["export", "-c", str(cfg), "-o", out, "--device", "cpu",
          "--identify-mesh", "data=2,gallery=2", "--gallery-rows",
          str(ROWS)])
    return out


@pytest.fixture(scope="module")
def params():
    return model_params(_config())


@pytest.fixture(scope="module")
def f32(cli_dir):
    """The CLI's identify engine, loaded cold: no mesh given, so it builds
    the frozen shape on the CPU."""
    return IdentifyEngine(os.path.join(cli_dir, "identify.fke"))


@pytest.fixture(scope="module")
def pipe(params):
    return FacePipeline(_config(), *params, device="cpu")


def _galleries(rng, pipe, frames, dtype):
    """A 64-row gallery holding one face of each frame at rows 3 and 40
    (a top row in each shard), in ``dtype``, whole and sharded over the
    engine's mesh shape."""
    g = _unit(rng, ROWS)
    res = pipe.recognize_frames(frames)
    g[[3, 40]] = res.embeddings[[0, 1], res.valid.int().argmax(1)].numpy()
    return g


def _eager(pipe, mesh, g, count, frames, dtype):
    gt = torch.tensor(g)
    if dtype == "int8":
        q, s = quantize_rows_int8(gt)
        gal, scales = shard_gallery(q, mesh), shard_rows(s, mesh)
    else:
        gal, scales = shard_gallery(gt.to(getattr(torch, dtype)), mesh), None
    res, sims, idx = pipe.recognize_and_match(
        frames, gal, count, k=2, return_crops=True, gallery_scale=scales,
        mesh=mesh)
    return gal, scales, (res.boxes, res.scores, res.valid, res.embeddings,
                         sims, idx, res.crops)


def test_cli_writes_the_identify_ladder(cli_dir, f32):
    """``--identify-mesh`` and ``--gallery-rows``: the recognize / embed
    pair and one identify engine, its sidecar with facekit's fields (no
    ``platforms`` or ``use_pallas``) and the port's."""
    assert sorted(f for f in os.listdir(cli_dir) if f.endswith(".fke")) \
        == ["embed.fke", "identify.fke", "recognize.fke"]
    meta = json.load(open(os.path.join(cli_dir, "identify.fke.json")))
    assert meta["program"] == "identify" and meta["batch_size"] == B
    assert meta["gallery_rows"] == ROWS and meta["mesh_shape"] == MESH
    assert meta["gallery_dtype"] == "float32" and meta["gallery_topk"] == 2
    assert meta["device"] == "cpu" and meta["positions"] == 4
    assert meta["mesh_devices"] == ["cpu"] * 4 and meta["return_crops"]
    assert "platforms" not in meta and "use_pallas" not in meta
    assert f32.mesh.shape == MESH and f32.gallery_rows == ROWS


@pytest.mark.parametrize("count", [1, 20, 50])
def test_engine_equals_eager_mesh(f32, pipe, count):
    """Every output bit for bit as the eager mesh pipeline, at a count
    where the first shard holds fewer than k live rows (1), one that
    leaves the second shard empty (20) and one over both (50): the live
    count is a runtime value of the program, not its export value."""
    rng = np.random.default_rng(5)
    frames = _frames(7)
    g = _galleries(rng, pipe, frames, "float32")
    gal, _, want = _eager(pipe, f32.mesh, g, count, frames, "float32")
    got = f32(*f32.states(pipe), gal, count, frames)
    assert len(got) == 7
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    idx = got[5]
    assert bool((idx < max(count, 2)).all())
    if count == 1:     # one live row: the second is the first padding row
        assert bool((idx[..., 1] == 1).all())


@pytest.fixture(scope="module")
def facekit_meshes(params):
    """facekit's pipeline on its 8-device mesh, same weights."""
    rp, dp = params
    kw = {k: v for k, v in _CFG.items() if k != "extras"}
    return JaxPipeline(JaxConfig(**kw), dp, rp), jax_make_mesh(
        {"data": 2, "gallery": 4})


def _check_facekit(got, ref, sim_atol):
    boxes, scores, valid, emb, sims, idx, crops = got
    res, rsims, ridx = ref
    np.testing.assert_array_equal(valid.numpy(), np.asarray(res.valid))
    assert valid.any()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    for a, b in ((boxes, res.boxes), (scores, res.scores),
                 (emb, res.embeddings)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(sims.numpy(), np.asarray(rsims),
                               atol=sim_atol)


def test_engine_matches_facekit(f32, pipe, facekit_meshes):
    """Against facekit's mesh ``recognize_and_match`` on the same
    numpy-drawn weights, frames and gallery: detections and indices
    equal, floats within 1e-4."""
    ref, jmesh = facekit_meshes
    rng = np.random.default_rng(9)
    frames = _frames(11)
    g = _galleries(rng, pipe, frames, "float32")
    gal = shard_gallery(torch.tensor(g), f32.mesh)
    got = f32(*f32.states(pipe), gal, 50, frames)
    want = ref.recognize_and_match(
        frames, jax_shard_gallery(jnp.asarray(g), jmesh), 50, k=2,
        use_pallas=False, return_crops=True, mesh=jmesh)
    _check_facekit(got, want, 1e-4)


@pytest.fixture(scope="module")
def low_precision(params):
    """Identify engines of a bf16 and an int8 gallery (the scales
    sharded with the rows) on a ``{"gallery": 2}`` mesh given to them,
    exported through the API and served from the program in memory (the
    f32 engine is the one read back from its file)."""
    mesh = make_mesh({"gallery": 2}, devices=["cpu"] * 2)
    engines = {}
    for dtype in ("bfloat16", "int8"):
        p = FacePipeline(_config(gallery_dtype=dtype), *params, device="cpu")
        program, meta = export_identify_engine(p, B, ROWS, mesh=mesh,
                                               return_crops=True)
        engines[dtype] = (p, IdentifyEngine(f"identify_{dtype}", mesh, meta,
                                            program))
    return engines


@pytest.mark.parametrize("count", [1, 20])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_low_precision_gallery_equals_eager(low_precision, dtype, count):
    """bf16 and int8 galleries: bit for bit as the eager mesh pipeline at
    both counts; the int8 engine takes the scales block by block."""
    p, eng = low_precision[dtype]
    rng = np.random.default_rng(13)
    frames = _frames(17)
    g = _galleries(rng, p, frames, dtype)
    gal, scales, want = _eager(p, eng.mesh, g, count, frames, dtype)
    got = eng(*eng.states(p), gal, count, frames, gallery_scale=scales)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_int8_gallery_matches_facekit(low_precision, facekit_meshes):
    """The int8 engine against facekit's mesh program over its int8
    gallery (rows and scales sharded 4 ways)."""
    p, eng = low_precision["int8"]
    _, jmesh = facekit_meshes
    rp, dp = model_params(_config())
    kw = {k: v for k, v in _CFG.items() if k != "extras"}
    ref = JaxPipeline(JaxConfig(**dict(kw, gallery_dtype="int8")), dp, rp)
    rng = np.random.default_rng(19)
    frames = _frames(23)
    g = _galleries(rng, p, frames, "int8")
    q, s = quantize_rows_int8(torch.tensor(g))
    got = eng(*eng.states(p), shard_gallery(q, eng.mesh), 50, frames,
              gallery_scale=shard_rows(s, eng.mesh))
    jq, js = jax_quantize(jnp.asarray(g))
    want = ref.recognize_and_match(
        frames, jax_shard_gallery(jq, jmesh), 50, k=2, use_pallas=False,
        return_crops=True, gallery_scale=jax_shard_rows(js, jmesh),
        mesh=jmesh)
    _check_facekit(got, want, INT8_SIM_ATOL)


def _copy(cli_dir, tmp_path, edits=None, extra=None):
    """A copy of the CLI's identify engine in a directory of its own,
    its sidecar edited (``edits``), and ``extra`` (name -> sidecar edits)
    more copies of it."""
    dst = tmp_path / "e"
    dst.mkdir()
    src = os.path.join(cli_dir, "identify.fke")
    for name, change in [("identify.fke", edits)] + list(
            (extra or {}).items()):
        shutil.copy(src, dst / name)
        meta = json.load(open(src + ".json"))
        meta.update(change or {})
        json.dump(meta, open(dst / f"{name}.json", "w"))
    return str(dst)


REFUSALS = ["wrong_mesh", "no_mesh", "wrong_batch", "wrong_capacity",
            "missing_scales", "stale_statics", "differing_state",
            "duplicate_batch", "disagreeing_capacity", "device_map"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals(case, cli_dir, f32, pipe, low_precision, tmp_path):
    """facekit's refusals (``tests/test_engine_identify.py:106-140,
    229-244``) and the port's: a mesh of another shape (with the
    re-export hint), an unsharded engine on a mesh, a wrong batch,
    capacity or missing int8 scales at the call, stale statics, a
    pipeline whose state differs, two engines for one batch, engines that
    disagree on the capacity, and a device map that is not a function."""
    path = os.path.join(cli_dir, "identify.fke")
    cfg = _config()
    mesh = f32.mesh
    gal = shard_gallery(torch.zeros((ROWS, 512)), mesh)
    if case == "wrong_mesh":
        with pytest.raises(ValueError, match="sharded for mesh.*"
                           "--identify-mesh data=4,gallery=1"):
            IdentifyEngine(path, make_mesh({"data": 4, "gallery": 1},
                                           devices=["cpu"] * 4))
    elif case == "no_mesh":
        d = _copy(cli_dir, tmp_path, {"mesh_shape": None,
                                      "mesh_devices": ["cpu"]})
        with pytest.raises(ValueError, match="exported without a mesh"):
            IdentifyEngine(os.path.join(d, "identify.fke"), mesh)
    elif case == "wrong_batch":
        with pytest.raises(ValueError, match="frozen at batch 2, got 3"):
            f32(*f32.states(pipe), gal, 5, _frames(1, 3))
    elif case == "wrong_capacity":
        big = shard_gallery(torch.zeros((2 * ROWS, 512)), mesh)
        with pytest.raises(ValueError, match="frozen at gallery capacity "
                           "64, got 128.*--gallery-rows >= 128"):
            f32(*f32.states(pipe), big, 5, _frames(1))
    elif case == "missing_scales":
        p, eng = low_precision["int8"]
        q = shard_gallery(torch.zeros((ROWS, 512), dtype=torch.int8),
                          eng.mesh)
        with pytest.raises(ValueError, match="gallery_scale"):
            eng(*eng.states(p), q, 5, _frames(1))
    elif case == "stale_statics":
        with pytest.raises(ValueError, match="det_threshold_bbox"):
            load_identify_engines(cli_dir, _config(det_threshold_bbox=0.4),
                                  pipe, mesh)
    elif case == "differing_state":
        meta = json.load(open(path + ".json"))
        rec = meta["rec_state"]
        rec[0] = [rec[0][0], [1] + rec[0][1][1:], rec[0][2]]
        d = _copy(cli_dir, tmp_path, {"rec_state": rec})
        with pytest.raises(ValueError, match="rec_state differs.*entry 0"):
            load_identify_engines(d, cfg, pipe, mesh)
    elif case == "duplicate_batch":
        d = _copy(cli_dir, tmp_path, extra={"identify.b2.fke": {}})
        with pytest.raises(ValueError, match="duplicate identify engine "
                           "for batch 2"):
            load_identify_engines(d, cfg, pipe, mesh)
    elif case == "disagreeing_capacity":
        d = _copy(cli_dir, tmp_path, extra={"identify.b4.fke": {
            "batch_size": 4, "gallery_rows": 2 * ROWS}})
        with pytest.raises(ValueError, match="disagree on the frozen "
                           "gallery capacity"):
            load_identify_engines(d, cfg, pipe, mesh)
    else:
        # exported with one device at every position, served on two
        with pytest.raises(ValueError, match="cannot be placed"):
            IdentifyEngine(path, make_mesh(MESH, devices=[
                "cpu", "cpu", "meta", "meta"]))
        assert device_map("x", ["cuda:0", "cuda:1"] * 2,
                          ["cuda:0"] * 4) == {"cuda:0": "cuda:0",
                                              "cuda:1": "cuda:0"}


def test_engine_served_through_a_device_map(f32, pipe):
    """An engine whose sidecar names other devices than the serving
    mesh's goes through ``move_to_device_pass`` with the position map,
    and serves as before."""
    meta = dict(f32.meta, mesh_devices=["cuda:0", "cuda:1"] * 2)
    eng = IdentifyEngine(f32.path, f32.mesh, meta, f32.program)
    frames = _frames(37)
    g = _galleries(np.random.default_rng(41), pipe, frames, "float32")
    gal = shard_gallery(torch.tensor(g), f32.mesh)
    for a, b in zip(eng(*eng.states(pipe), gal, 30, frames),
                    f32(*f32.states(pipe), gal, 30, frames)):
        assert torch.equal(a, b)


# -- a mesh server booted from identify engines -------------------------------

def _server_config(tmp, name, **fields):
    return FaceKitConfig(**dict(_CFG, database_path=str(tmp / f"{name}.db"),
                                mesh_shape=dict(MESH), **fields))


@pytest.fixture(scope="module")
def servers(cli_dir, tmp_path_factory):
    """An eager mesh server and one booted from the CLI's identify engine
    (warmed), on the weights the config draws."""
    tmp = tmp_path_factory.mktemp("servers")
    eager = FaceServer(_server_config(tmp, "eager"), warmup=False,
                       device="cpu")
    served = FaceServer(_server_config(tmp, "served"), warmup=True,
                        device="cpu", engines_dir=cli_dir)
    yield eager, served
    eager.close()
    served.close()


def test_server_boots_from_identify_engines(servers):
    """The identify engine serves every bucket; no pair is loaded; the
    gallery's capacity is pinned to the frozen rows, sharded over the
    mesh."""
    eager, served = servers
    assert sorted(served.identify_engines) == served.batch_buckets == [B]
    assert served.engines is None and eager.identify_engines is None
    assert served.gallery.buckets == (ROWS,)
    assert served.gallery.capacity == ROWS
    assert len(served.gallery.snapshot().arr.blocks) == MESH["gallery"]


def _jpg(img):
    return cv2.imencode(".jpg", img)[1].tobytes()


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


async def test_ws_inference_as_the_eager_mesh_server(servers):
    """WS /inference through the identify engine (three frames, two in
    flight) and /recognize (eager on the mesh in both) answer byte for
    byte as the eager mesh server, the crop's JPEG included."""
    eager, served = servers
    frames = _frames(29, 3)
    jpgs = [_jpg(f) for f in frames]
    res = eager.pipeline.recognize_frames(np.stack(
        [eager.pixels.decode(j) for j in jpgs]), return_crops=True)
    slot = int(res.valid[0].int().argmax())
    for srv in (eager, served):
        srv.db.insert_user("ann", "Ann")
        assert srv.db.insert_face("ann", "ann.jpg",
                                  res.embeddings[0, slot].numpy()) == 1
    replies = []
    async with _clients(eager, served) as clients:
        for c in clients:
            assert (await c.get("/reload")).status == 200
            ws = await _ws(c, jpgs)
            rec = await (await c.post("/recognize", data=jpgs[1])).text()
            replies.append((ws, rec))
    assert replies[1] == replies[0]
    assert json.loads(replies[1][0][0])["userId"] == "ann"
    assert all(json.loads(t)["image"] for t in replies[1][0])


def test_server_refuses_missing_bucket(cli_dir, tmp_path):
    extras = dict(_CFG["extras"], server_batchBuckets=[B, 4])
    with pytest.raises(ValueError, match=r"identify engine for batch "
                       r"bucket\(s\) \[4\].*-b 2,4 --identify-mesh "
                       "data=2,gallery=2"):
        FaceServer(_server_config(tmp_path, "x", extras=extras),
                   warmup=False, device="cpu", engines_dir=cli_dir)


def test_server_refuses_no_crops(cli_dir, tmp_path):
    d = _copy(cli_dir, tmp_path, {"return_crops": False})
    with pytest.raises(ValueError, match="identify engine was exported "
                       "without the crops.*--no-crops"):
        FaceServer(_server_config(tmp_path, "x"), warmup=False,
                   device="cpu", engines_dir=d)


def test_server_refuses_reload_past_frozen_capacity(servers):
    """A reload that needs more rows than the engines froze refuses
    before the swap: the old gallery keeps serving."""
    _, served = servers
    before = served.gallery.snapshot()
    rows = _unit(np.random.default_rng(31), ROWS + 1)
    served.db.insert_user("many", "Many")
    for i, r in enumerate(rows):
        served.db.insert_face("many", f"{i}.jpg", r)
    try:
        with pytest.raises(ValueError, match="frozen at capacity 64.*"
                           f"--gallery-rows >= {before.count + ROWS + 1}"):
            served.reload_gallery()
        assert served.gallery.snapshot().arr is before.arr
        assert served.gallery.count == before.count
        out = served.inference_batch(list(_frames(29, 1)))
        assert out[0] is None or out[0]["userId"] == "ann"
    finally:
        served.db.delete_user("many")
