"""Gen mode (batch enrollment of a ``<class>/<img>`` tree, reference
src/app.cpp:69-99) in facekit_torch against facekit's
``FaceServer.enroll_folder``, and ``main()`` with ``gen: true``.

Both servers get the same numpy-drawn parameters and the same files; the
count, the users, the row order and the stored embeddings must agree
(f32, ``ir_tiny``).
"""

import dataclasses
import json
import sqlite3

import cv2
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.server import FaceServer as JaxServer
from facekit_torch.config import FaceKitConfig
from facekit_torch.db import Database
from facekit_torch.ops.boxes import select_faces_batch
from facekit_torch.server import FaceServer
from facekit_torch.server.app import main as server_main
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params, save_params)

_COMMON = dict(rec_network="ir_tiny", compute_dtype="float32",
               gallery_dtype="float32", gallery_bucket_sizes=(16, 64),
               input_frameWidth=160, input_frameHeight=120,
               det_inputShape=(3, 96, 128))
# the f32 bars of the port's other tests: crops embed within 1e-5
# (tests/test_torch_arcface.py); detected faces within 1e-4, as their
# crop pixels agree within 1e-4 of full scale, not bit for bit
# (tests/test_torch_server.py)
CROPPED_ATOL = 1e-5
DETECTED_ATOL = 1e-4
# a detected image is compared with facekit only where no score sits
# within this of the threshold (both frameworks' scores carry float
# differences)
SCORE_MARGIN = 1e-3


def _servers(tmp, extras, det_params, **override):
    """facekit's server and the port's on one config and one tree."""
    rec = random_arcface_params("ir_tiny", seed=21)
    cfg = dict(_COMMON, extras=dict(extras), **override)
    ref = JaxServer(JaxConfig(database_path=str(tmp / "jax.db"),
                              use_pallas_search=False, **cfg),
                    det_params=det_params, rec_params=rec, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp / "torch.db"),
                                    **cfg),
                      rec_params=rec, det_params=det_params, warmup=False,
                      device="cpu")
    return ref, ours


def _images(rng, kind, hw):
    """A frame of one of four kinds: noise, flat, a ramp, noise with a
    flat block."""
    h, w = hw
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        return np.full((h, w, 3), rng.integers(0, 256), np.uint8)
    if kind == 2:
        ramp = np.linspace(0, 255 * rng.uniform(0.2, 1), w)
        return np.broadcast_to(ramp[None, :, None], (h, w, 3)).astype(np.uint8)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[h // 4:3 * h // 4, w // 3:2 * w // 3] = rng.integers(0, 256)
    return img


def _tree(root, rng, classes, per_class, hw_of):
    """<root>/<class>/<i>.png, a stray top-level file and a file no codec
    reads; returns the image paths in enrollment order."""
    paths = []
    for c in classes:
        d = root / c
        d.mkdir(parents=True)
        for i in range(per_class):
            p = d / f"{i}.png"
            cv2.imwrite(str(p), _images(rng, (len(paths) + i) % 4,
                                        hw_of(len(paths))))
            paths.append(p)
    (root / "README.txt").write_text("not a class folder")
    (root / classes[0] / "notes.txt").write_text("not an image")
    return paths


def _rows(db_path):
    con = sqlite3.connect(db_path)
    try:
        rows = con.execute("SELECT USR_ID, IMG_PATH, EMBEDDING FROM FACE "
                           "ORDER BY IMG_ID").fetchall()
    finally:
        con.close()
    return [(u, p, np.frombuffer(e, "<f4")) for u, p, e in rows]


def test_enroll_folder_cropped_matches_facekit(tmp_path):
    """Crops of any size, in chunks of server_batchSize = 4 (the last one
    padded): the same count, users, row order and embeddings as facekit."""
    rng = np.random.default_rng(22)
    src = tmp_path / "people"
    _tree(src, rng, ("alice", "bob", "carol"), 3,
          lambda i: (112, 112) if i % 2 else (120, 100))
    ref, ours = _servers(tmp_path, {"server_batchSize": 4},
                         random_retinaface_params(seed=0))
    try:
        n = ours.enroll_folder(str(src), is_cropped=True)
        assert n == ref.enroll_folder(str(src), is_cropped=True) == 9
        assert ours.db.get_num_embeddings() == 9
        assert ours.db.get_user_dict() == ref.db.get_user_dict() == {
            c: c for c in ("alice", "bob", "carol")}
        mine, theirs = (_rows(s.config.database_path) for s in (ours, ref))
        assert [r[:2] for r in mine] == [r[:2] for r in theirs]
        np.testing.assert_allclose(np.stack([r[2] for r in mine]),
                                   np.stack([r[2] for r in theirs]),
                                   rtol=0, atol=CROPPED_ATOL)
        assert ours.reload_gallery() == 9
    finally:
        ours.close()


def _conv_gain(node, gain):
    """A detector tree with every conv weight scaled by ``gain``."""
    if isinstance(node, dict):
        return {k: (v * gain if k in ("conv", "dw_conv", "pw_conv")
                    else _conv_gain(v, gain)) for k, v in node.items()}
    if isinstance(node, list):
        return [_conv_gain(v, gain) for v in node]
    return node


# torch's default conv init shrinks the signal's variance about 6x a
# layer, so random_retinaface_params' scores barely depend on the frame
# (every frame gets the same 4 boxes near 0.549). Scaled by 2, the
# detector's scores spread over 0.55-0.88 by frame, and at this threshold
# two of the test's 16 frames keep exactly one face, three several and
# the rest none, each count unchanged with the threshold moved by
# SCORE_MARGIN.
DET_GAIN = 2.0
DET_THRESHOLD = 0.795


def _faces_at(pipe, frames, threshold):
    """Valid faces per frame at another detection threshold."""
    cfg = pipe.config
    loc, conf, ldm = pipe._detector_outputs(torch.tensor(frames))
    return select_faces_batch(
        loc, conf, pipe.anchors, cfg.frame_hw, cfg.det_hw,
        max_faces=cfg.det_maxFacesPerScene, score_threshold=threshold,
        iou_threshold=cfg.det_threshold_nms, nms_top_k=cfg.det_nmsTopK,
        nms_exact=cfg.det_nmsExact, ldm=ldm).valid.sum(-1)


def test_enroll_folder_detected_matches_facekit(tmp_path):
    """Whole images through the detector: an image is enrolled only when
    exactly one face is valid. The count equals the port's own
    ``recognize_frames`` on the identically padded batches; image by
    image, where its face count holds with the threshold moved by
    SCORE_MARGIN either way, the port enrolls what facekit enrolls, with
    the same embedding."""
    rng = np.random.default_rng(23)
    src = tmp_path / "tree"
    paths = _tree(src, rng, ("dave", "erin", "fay", "gil"), 4,
                  lambda i: (240, 320) if i % 3 == 0 else (120, 160))
    det = _conv_gain(random_retinaface_params(seed=0), DET_GAIN)
    ref, ours = _servers(tmp_path, {"server_batchSize": 4,
                                    "rec_useAlignment": True}, det,
                         det_threshold_bbox=DET_THRESHOLD)
    try:
        ok, clear, r_ok, n_faces = {}, {}, {}, {}
        bs = ours.batch_size
        for i in range(0, len(paths), bs):
            chunk = paths[i:i + bs]
            frames = np.zeros((bs, 120, 160, 3), np.uint8)
            for j, p in enumerate(chunk):
                frames[j] = cv2.resize(cv2.imread(str(p)), (160, 120))
            faces = ours.pipeline.recognize_frames(frames).valid.sum(-1)
            r_faces = np.asarray(
                ref.pipeline.recognize_frames(frames).valid).sum(-1)
            low, high = (_faces_at(ours.pipeline, frames, DET_THRESHOLD + d)
                         for d in (-SCORE_MARGIN, SCORE_MARGIN))
            for j, p in enumerate(chunk):
                n_faces[str(p)] = int(faces[j])
                ok[str(p)] = int(faces[j]) == 1
                r_ok[str(p)] = int(r_faces[j]) == 1
                clear[str(p)] = int(low[j]) == int(high[j]) == int(faces[j])
        kinds = {(clear[p], min(n_faces[p], 2)) for p in ok}
        assert {(True, 0), (True, 1), (True, 2)} <= kinds
        assert sum(clear[p] and ok[p] for p in ok) >= 2

        n = ours.enroll_folder(str(src), is_cropped=False)
        assert n == sum(ok.values())
        assert ours.db.get_num_embeddings() == n
        assert ref.enroll_folder(str(src), is_cropped=False) == sum(
            r_ok.values())
        mine = {p: (u, e) for u, p, e in _rows(ours.config.database_path)}
        theirs = {p: (u, e) for u, p, e in _rows(ref.config.database_path)}
        assert sorted(mine) == sorted(p for p in ok if ok[p])
        for p in (p for p in ok if clear[p]):
            assert (p in mine) == (p in theirs) == r_ok[p] == ok[p], p
            if p in mine:
                assert mine[p][0] == theirs[p][0]
                np.testing.assert_allclose(mine[p][1], theirs[p][1], rtol=0,
                                           atol=DETECTED_ATOL)
    finally:
        ours.close()


def test_main_gen_mode_enrolls_and_returns(tmp_path, caplog):
    """``gen: true``: ``main()`` builds the server from the config's weight
    files, enrolls ``gen_imgSource`` and returns without serving; the
    database holds one row per image, embedded as a server given the
    same tree embeds them."""
    rng = np.random.default_rng(24)
    src = tmp_path / "gen"
    _tree(src, rng, ("gus", "hal"), 3, lambda i: (112, 112))
    rec = random_arcface_params("ir_tiny", seed=25)
    det = random_retinaface_params(seed=26)
    save_params(rec, str(tmp_path / "rec.msgpack"))
    save_params(det, str(tmp_path / "det.msgpack"))
    cfg = dict(_COMMON, gallery_bucket_sizes=[16, 64],
               det_inputShape=[3, 96, 128], gen=True,
               gen_imgSource=str(src), gen_imgIsCropped=True,
               database_path=str(tmp_path / "gen.db"),
               rec_weights=str(tmp_path / "rec.msgpack"),
               det_weights=str(tmp_path / "det.msgpack"),
               server_batchSize=4)
    path = tmp_path / "gen.json"
    path.write_text(json.dumps(cfg))
    with caplog.at_level("INFO", logger="facekit_torch.server"):
        assert server_main(["-c", str(path), "--device", "cpu",
                            "--no-warmup"]) is None
    assert "Database generated (6 faces)" in caplog.text
    db = Database(cfg["database_path"], 512)
    try:
        assert db.get_num_embeddings() == 6
        assert db.get_user_dict() == {"gus": "gus", "hal": "hal"}
        names, embs = db.get_embeddings()
    finally:
        db.close()
    assert names == ["gus"] * 3 + ["hal"] * 3
    fresh = FaceKitConfig(**dict(_COMMON, database_path=str(
        tmp_path / "check.db"), extras={"server_batchSize": 4}))
    check = FaceServer(fresh, rec_params=rec, det_params=det, warmup=False,
                       device="cpu")
    try:
        crops = [cv2.imread(str(p)) for c in ("gus", "hal")
                 for p in sorted((src / c).glob("*.png"))]
        expect = np.concatenate([
            check.pipeline.embed_cropped_batch(check.pad_batch(crops[i:i + 4]))
            [:len(crops[i:i + 4])] for i in range(0, 6, 4)])
    finally:
        check.close()
    np.testing.assert_array_equal(embs, expect)


def test_gen_config_is_no_longer_refused(tmp_path):
    cfg = FaceKitConfig(database_path=str(tmp_path / "x.db"), gen=True,
                        **_COMMON)
    FaceServer(cfg, warmup=False, device="cpu").close()


@pytest.mark.parametrize("override", [{"extras": {"rec_int8Residual": True}},
                                      {"extras": {"profiler_port": 9999}}])
def test_gen_does_not_lift_other_refusals(override, tmp_path):
    cfg = dataclasses.replace(FaceKitConfig(
        database_path=str(tmp_path / "x.db"), gen=True, **_COMMON),
        **override)
    with pytest.raises(ValueError, match="not ported"):
        FaceServer(cfg, warmup=False, device="cpu")
