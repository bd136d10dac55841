"""facekit_torch's native host ops (``facekit_torch/native``) against cv2
and the port's own torch ops, and the server on the native pixel backend
(``extras.server_hostOps: "native"``) against the cv2 one, on the CPU.

The bars are facekit's own (``tests/test_native.py``): JPEG decode
bit-identical to ``cv2.imdecode``; resize and the fused letterbox within
1 + 1e-4 of cv2's and the port's; NMS and the gallery scan with the
indices of the port's ops. facekit's bindings are not imported: they
build their library in place at first use.
"""

import base64
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

from facekit_torch import native
from facekit_torch.config import FaceKitConfig
from facekit_torch.ops import _build
from facekit_torch.ops.boxes import nms as torch_nms
from facekit_torch.ops.preprocess import det_normalize
from facekit_torch.ops.resize import letterbox
from facekit_torch.ops.similarity import cosine_topk_reference
from facekit_torch.server import FaceServer, make_app
from facekit_torch.server import app as server_app
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESAMPLE_ATOL = 1.0 + 1e-4


@pytest.fixture(scope="module")
def lib():
    """The library, built at first use; a machine without g++ or libjpeg
    fails here with the compiler's message."""
    assert native.available(), native.build_error()
    return native


@pytest.mark.parametrize("method,flag", [("linear", cv2.INTER_LINEAR),
                                         ("cubic", cv2.INTER_CUBIC)])
def test_resize_matches_cv2(lib, method, flag):
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    ours = lib.resize_u8(img, (288, 320), method)
    ref = cv2.resize(img, (320, 288), interpolation=flag).astype(np.float32)
    assert ours.dtype == np.float32 and ours.shape == (288, 320, 3)
    assert np.abs(ours - ref).max() <= RESAMPLE_ATOL


@pytest.mark.parametrize("frame_hw", [(480, 640), (120, 160), (300, 200)])
def test_letterbox_matches_the_ports(lib, frame_hw):
    """The fused host letterbox + mean subtraction against the port's
    ``letterbox`` + ``det_normalize``."""
    rng = np.random.default_rng(32)
    frame = rng.integers(0, 256, size=(*frame_hw, 3), dtype=np.uint8)
    ours = lib.letterbox_det(frame, (288, 320))
    ref = det_normalize(letterbox(torch.tensor(frame), (288, 320))).numpy()
    assert np.abs(ours - ref).max() <= RESAMPLE_ATOL


@pytest.mark.parametrize("iou", [0.3, 0.4, 0.7])
def test_nms_matches_the_ports(lib, iou):
    rng = np.random.default_rng(33)
    n = 80
    centers = rng.uniform(50, 400, size=(n, 2))
    sizes = rng.uniform(20, 120, size=(n, 2))
    boxes = np.concatenate([centers - sizes / 2,
                            centers + sizes / 2], 1).astype(np.float32)
    scores = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    kept = lib.nms(boxes, scores, iou, max_out=n)
    _, _, keep, idx = torch_nms(torch.tensor(boxes), torch.tensor(scores),
                                iou, top_k=n)
    np.testing.assert_array_equal(kept, idx[keep].numpy())
    assert len(lib.nms(boxes, scores, iou, max_out=3)) == 3


def test_gallery_top1_matches_the_plain_search(lib):
    rng = np.random.default_rng(34)
    gallery = rng.normal(size=(5000, 512)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    queries = (gallery[[7, 42, 4999, 0]]
               + rng.normal(0, 0.05, (4, 512))).astype(np.float32)
    scores, idx = lib.gallery_top1(gallery, queries)
    ref_s, ref_i = cosine_topk_reference(torch.tensor(gallery),
                                         torch.tensor(queries), 5000, 1)
    np.testing.assert_array_equal(idx, ref_i[:, 0].numpy())
    np.testing.assert_allclose(scores, ref_s[:, 0].numpy(), rtol=1e-5)
    s0, i0 = lib.gallery_top1(gallery[:0], queries)
    assert (i0 == -1).all() and (s0 == np.float32(-1e30)).all()
    with pytest.raises(ValueError):           # a width the C side would
        lib.gallery_top1(gallery, queries[:, :256])   # read past


def test_shapes_are_checked_before_the_pointers(lib):
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError):
        lib.resize_u8(img[:, :, 0], (4, 4))
    with pytest.raises(ValueError):
        lib.letterbox_det(img[:, :, :2], (4, 4))
    with pytest.raises(ValueError):
        lib.nms(np.zeros((3, 4), np.float32), np.zeros(2, np.float32), 0.5)


def test_decode_is_bit_identical_to_cv2(lib):
    rng = np.random.default_rng(35)
    img = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    data = cv2.imencode(".jpg", img)[1].tobytes()
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(lib.decode_jpeg_bgr(data), ref)
    gray = cv2.imencode(".jpg", img[:, :, 0])[1].tobytes()
    refg = cv2.cvtColor(cv2.imdecode(np.frombuffer(gray, np.uint8),
                                     cv2.IMREAD_GRAYSCALE),
                        cv2.COLOR_GRAY2BGR)
    np.testing.assert_array_equal(lib.decode_jpeg_bgr(gray), refg)


def test_decode_with_resize(lib):
    rng = np.random.default_rng(36)
    img = rng.integers(0, 256, size=(120, 160, 3), dtype=np.uint8)
    data = cv2.imencode(".jpg", img)[1].tobytes()
    ours = lib.decode_jpeg_bgr(data, (80, 60))
    ref = cv2.resize(cv2.imdecode(np.frombuffer(data, np.uint8),
                                  cv2.IMREAD_COLOR), (80, 60))
    assert ours.shape == (60, 80, 3) and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_garbage_decodes_to_none(lib):
    ok = np.zeros((16, 16, 3), np.uint8)
    data = cv2.imencode(".jpg", ok)[1].tobytes()
    assert lib.decode_jpeg_bgr(b"not a jpeg") is None
    assert lib.decode_jpeg_bgr(b"") is None
    assert lib.decode_jpeg_bgr(data[:40]) is None             # truncated
    assert lib.decode_jpeg_bgr(cv2.imencode(".png", ok)[1].tobytes()) is None


def test_encode_round_trips(lib):
    rng = np.random.default_rng(37)
    img = rng.integers(0, 256, size=(112, 112, 3), dtype=np.uint8)
    enc = lib.encode_jpeg_bgr(img)
    assert enc is not None and enc[:2] == b"\xff\xd8"
    back = lib.decode_jpeg_bgr(enc)
    np.testing.assert_array_equal(
        back, cv2.imdecode(np.frombuffer(enc, np.uint8), cv2.IMREAD_COLOR))
    # a lossy codec on noise: cv2's own round trip at the same quality
    cv2_back = cv2.imdecode(cv2.imencode(".jpg", img)[1], cv2.IMREAD_COLOR)
    ours_err = np.abs(back.astype(int) - img.astype(int)).mean()
    cv2_err = np.abs(cv2_back.astype(int) - img.astype(int)).mean()
    assert ours_err <= cv2_err * 1.5 + 1
    with pytest.raises(ValueError):
        lib.encode_jpeg_bgr(img[:, :, :2])


def test_two_processes_build_at_once(tmp_path):
    """Two fresh interpreters build the library into one empty directory
    at the same moment: each compiles into a file of its own and renames
    it into place, so both load it and one library is left, with no
    temporary file. Nothing is built at import. The directory is checked
    empty here, before the children start: a child that looked itself
    could find the other's temporary file already there."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from facekit_torch.ops import _build\n"
        "import facekit_torch.native as native\n"
        "_build.BUILD_DIR = Path(sys.argv[1])\n"
        "assert native._lib is None and native._error is None\n"
        "assert native.available(), native.build_error()\n"
        "print(native.gallery_top1(__import__('numpy').eye(3, dtype="
        "'float32'), __import__('numpy').eye(3, dtype='float32')[[2]])"
        "[1][0])\n")
    out_dir = tmp_path / "build"
    out_dir.mkdir()
    assert not any(out_dir.iterdir())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out_dir)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.strip() == "2"
    files = sorted(p.name for p in out_dir.iterdir())
    assert len(files) == 1 and files[0].startswith("libhost_ops-"), files
    assert files[0] == _build.host_library_path().name


# -- the server on the native pixel backend --------------------------------------

_CFG = dict(rec_network="ir_tiny", compute_dtype="float32",
            gallery_dtype="float32", gallery_bucket_sizes=(16, 64),
            det_inputShape=(3, 64, 64), input_frameWidth=160,
            input_frameHeight=120, det_threshold_bbox=0.5,
            api_imgIsCropped=True)


def _server(tmp, host_ops):
    extras = {"server_batchSize": 2, "rec_useAlignment": True}
    if host_ops:
        extras["server_hostOps"] = host_ops
    cfg = FaceKitConfig(database_path=str(tmp / f"{host_ops}.db"),
                        extras=extras, **_CFG)
    return FaceServer(cfg, rec_params=random_arcface_params("ir_tiny", seed=8),
                      det_params=random_retinaface_params(seed=0),
                      warmup=False, device="cpu")


async def test_native_server_answers_as_cv2(tmp_path):
    """Enrollment from a JPEG file, /recognize on a JPEG crop, WS
    /inference on two JPEG frames (already at the frame size, so no resize
    runs), a PNG on both routes: every reply equals the cv2 server's
    (decode is bit-identical), the reply crops decode to the same pixels
    within the codec's loss, and the PNG gets the failure reply "null"
    from the JPEG-only backend."""
    from aiohttp.test_utils import TestClient, TestServer
    rng = np.random.default_rng(38)
    crop = rng.integers(0, 256, size=(112, 112, 3), dtype=np.uint8)
    path = str(tmp_path / "face.jpg")
    cv2.imwrite(path, crop)
    crop_jpg = cv2.imencode(".jpg", crop)[1].tobytes()
    frames = [cv2.imencode(".jpg", rng.integers(
        0, 256, size=(120, 160, 3), dtype=np.uint8))[1].tobytes()
        for _ in range(2)]
    png = cv2.imencode(".png", crop)[1].tobytes()

    outs = {}
    for host_ops in ("native", None):
        srv = _server(tmp_path, host_ops)
        assert srv.pixels.name == (host_ops or "cv2")
        client = TestClient(TestServer(make_app(srv)))
        await client.start_server()
        try:
            r = await client.post("/insert/user", data=json.dumps(
                {"userId": "u", "userName": "U"}))
            assert "inserted" in await r.text()
            r = await client.post("/insert/face", data=json.dumps(
                {"data": [{"userId": "u", "imgPath": path}]}))
            assert "inserted successfully" in await r.text()
            await client.get("/reload")
            rec = await (await client.post("/recognize", data=crop_jpg)).text()
            rec_png = await (await client.post("/recognize",
                                               data=png)).text()
            ws = await client.ws_connect("/inference")
            for f in frames + [png]:
                await ws.send_bytes(f)
            replies = [(await ws.receive()).data for _ in range(3)]
            await ws.close()
            outs[host_ops or "cv2"] = (rec, rec_png, replies)
        finally:
            await client.close()
            srv.close()

    nat, ref = outs["native"], outs["cv2"]
    assert json.loads(nat[0]) == json.loads(ref[0])
    assert json.loads(nat[0])["userId"] == "u"
    assert nat[1] == "null" and ref[1] != "null"
    assert nat[2][2] == "null" and ref[2][2] != "null"
    for got, want in zip(nat[2][:2], ref[2][:2]):
        got, want = json.loads(got), json.loads(want)
        img_n, img_c = (cv2.imdecode(np.frombuffer(base64.b64decode(
            d.pop("image")), np.uint8), cv2.IMREAD_COLOR)
            for d in (got, want))
        assert got == want
        assert img_n.shape == img_c.shape == (112, 112, 3)
        assert np.abs(img_n.astype(int) - img_c.astype(int)).mean() < 2.0


def test_native_server_crops_equal_cv2s(tmp_path):
    """The batch function behind WS /inference, fed the frames each
    backend decodes from the same JPEGs: crops and matches equal."""
    rng = np.random.default_rng(39)
    jpgs = [cv2.imencode(".jpg", rng.integers(
        0, 256, size=(120, 160, 3), dtype=np.uint8))[1].tobytes()
        for _ in range(2)]
    outs = []
    for host_ops in ("native", None):
        srv = _server(tmp_path, host_ops)
        try:
            srv.db.insert_user("u", "U")
            srv.db.insert_face("u", "u.jpg", srv.pipeline.embed_cropped(
                np.full((112, 112, 3), 90, np.uint8)))
            srv.reload_gallery()
            frames = [srv.pixels.decode(j, (160, 120)) for j in jpgs]
            outs.append(srv.inference_batch(frames))
        finally:
            srv.close()
    for got, want in zip(*outs):
        assert got is not None and want is not None
        np.testing.assert_array_equal(got.pop("crop"), want.pop("crop"))
        assert got == want


def test_host_pixels_falls_back_loudly_without_cv2(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    with caplog.at_level(logging.WARNING, logger="facekit_torch.server"):
        px = server_app.host_pixels(FaceKitConfig())
    assert px.name == "native"
    assert "decodes JPEG only" in caplog.text
    caplog.clear()
    assert server_app.host_pixels(FaceKitConfig(extras={
        "server_hostOps": "native"})).name == "native"
    assert "cv2 not importable" not in caplog.text


def test_forced_native_that_cannot_build_refuses_to_start(monkeypatch,
                                                           tmp_path):
    """A forced native backend whose library failed to build raises at
    startup with the build's message; the cv2 default still starts."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "jpeglib.h: No such file")
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"),
                        extras={"server_hostOps": "native"}, **_CFG)
    with pytest.raises(RuntimeError, match="jpeglib.h: No such file"):
        FaceServer(cfg, warmup=False, device="cpu")
    FaceServer(dataclasses.replace(cfg, extras={}), warmup=False,
               device="cpu").close()
