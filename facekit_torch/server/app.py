"""The serving layer: the reference's HTTP contract on the torch pipeline.

Port of ``facekit/server/app.py:207-1198``: ``/insert/user``,
``/insert/face``, ``/delete/user``, ``/delete/face``, ``/recognize``, WS
``/inference``, ``/reload``, ``/search`` (k <= 64), ``/health``,
``/metrics`` and ``/probe/device``, with facekit's response strings
verbatim:

  * ``POST /recognize`` embeds the whole posted image as a face, with no
    detection (src/app.cpp:255-267), micro-batched; "null" on failure;
  * WS ``/inference`` runs each frame through detect -> align -> embed ->
    match (``FacePipeline.recognize_and_match``), micro-batched on its own
    batcher, and replies with the best valid face as JSON (with its crop
    as a base64 JPEG) or "null"; up to ``server_wsPipeline`` frames per
    connection are in flight and replies keep message order;
  * ``POST /insert/face`` persists to SQLite but does not update the live
    gallery — ``GET /reload`` does (src/app.cpp:189 note). With
    ``api_imgIsCropped: false`` each image goes through the detector and
    must hold exactly one face;
  * ``GET /probe/device?mb=8`` times an upload of fresh bytes and one
    tiny op's round trip on the serving device, at most once per
    ``server_probeCooldownS`` (429 otherwise).

With ``gen: true``, ``main`` enrolls the ``gen_imgSource`` folder tree in
batches (``FaceServer.enroll_folder``) and exits instead of serving.

Host pixel work uses OpenCV. A config that needs a part not ported yet is
refused at startup (``refuse_unported``). With ``rec_quantize`` the server
calibrates the int8 embedder from ``extras.rec_calibrationDir`` at startup
(``calibrate_from_config``). Device work runs on one executor thread; the
kernels launch on the device's current stream.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import concurrent.futures
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from facekit_torch.db import Database
from facekit_torch.gallery import GalleryStore
from facekit_torch.pipeline import FacePipeline
from facekit_torch.pipeline.recognize import CALIBRATION_HEADROOM
from facekit_torch.utils import LatencyTracker, resolve_device
from facekit_torch.models import detector_family
from facekit_torch.weights import load_params, random_arcface_params

log = logging.getLogger("facekit_torch.server")


class _Cv2Pixels:
    """Host pixel backend over OpenCV (``facekit/server/app.py:47-82``)."""

    name = "cv2"

    def __init__(self):
        import cv2
        self.cv2 = cv2

    def decode(self, data: bytes, resize_wh=None):
        cv2 = self.cv2
        frame = cv2.imdecode(np.frombuffer(data, np.uint8),
                             cv2.IMREAD_UNCHANGED)
        if frame is None:
            return None
        if frame.ndim == 2:
            frame = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
        elif frame.shape[-1] == 4:  # PNG with alpha (IMREAD_UNCHANGED)
            frame = cv2.cvtColor(frame, cv2.COLOR_BGRA2BGR)
        if resize_wh is not None and frame.shape[:2] != resize_wh[::-1]:
            frame = cv2.resize(frame, resize_wh)
        return frame

    def imread(self, path: str, resize_wh=None):
        img = self.cv2.imread(path)
        if img is not None and resize_wh is not None \
                and img.shape[:2] != resize_wh[::-1]:
            img = self.cv2.resize(img, resize_wh)
        return img

    def resize(self, img, wh):
        return self.cv2.resize(img, wh)

    def encode_jpg(self, img) -> Optional[bytes]:
        ok, buf = self.cv2.imencode(".jpg", img)
        return buf.tobytes() if ok else None


def refuse_unported(config) -> None:
    """Raise for a config that needs a part the port does not have yet."""
    reasons = []
    if config.extras.get("rec_int8Residual"):
        reasons.append("rec_int8Residual (s8-resident block outputs) is not "
                       "ported yet (ROADMAP.md Queue 1, int8 remainder)")
    if config.mesh_shape:
        reasons.append("mesh_shape needs multi-GPU serving (ROADMAP.md "
                       "Queue 1, parallel)")
    if config.extras.get("server_enginesDir"):
        reasons.append("server_enginesDir needs engine export (ROADMAP.md "
                       "Queue 1, export)")
    if config.extras.get("server_hostOps", "cv2") != "cv2":
        reasons.append("server_hostOps other than cv2 needs the native host "
                       "ops (ROADMAP.md Queue 1, server remainder)")
    if config.extras.get("profiler_port"):
        reasons.append("profiler_port (a live profiler server) is not ported "
                       "yet (ROADMAP.md Queue 1, server remainder)")
    if reasons:
        raise ValueError("config needs parts facekit_torch has not ported "
                         "yet: " + "; ".join(reasons))


def load_detector_params(config):
    """``config.det_weights`` as facekit restores it, into the template of
    ``config.det_network`` (``facekit/models/__init__.py:24-32``): a light
    detector's always holds its landmark heads (``landm``); RetinaFace's
    holds ``ldm_head`` only when ``det_withLandmarks``, so a head the
    template lacks is dropped and one it needs but the file lacks refuses
    to start."""
    params = load_params(config.det_weights)
    key = detector_family(config.det_network).landmarks
    if key == "ldm_head" and not config.det_withLandmarks:
        return {k: v for k, v in params.items() if k != key}
    if key not in params:
        raise ValueError(f"{config.det_weights}: det_network "
                         f"{config.det_network} with landmarks but the "
                         f"detector file has no {key}")
    return params


def random_detector_params(config, seed: int = 0):
    """Random params of ``config.det_network``'s detector, drawn with numpy
    (facekit's ``init_model_params`` draws its family's init)."""
    return detector_family(config.det_network).random_params(
        seed, config.det_withLandmarks)


def _load_calibration_crops(folder: str, rec_hw, pixels, batch: int = 16,
                            limit: int = 256):
    """Yield (N, rec_h, rec_w, 3) uint8 BGR batches from a folder of face
    images, resized to the embedder's input (``facekit/server/app.py:
    142-165``); raises ValueError when none is readable."""
    h, w = rec_hw
    acc = []
    n = 0
    for fname in sorted(os.listdir(folder)):
        img = pixels.imread(os.path.join(folder, fname), (w, h))
        if img is None:
            continue
        acc.append(img)
        n += 1
        if len(acc) == batch:
            yield np.stack(acc)
            acc = []
        if n >= limit:
            break
    if acc:
        yield np.stack(acc)
    if n == 0:
        raise ValueError(f"no readable calibration images in {folder}")


def calibrate_from_config(pipeline, config, pixels) -> bool:
    """Apply the config's int8 calibration (``extras.rec_calibrationDir``
    and ``rec_calibrationHeadroom``, default 1.25) to ``pipeline``
    (``facekit/server/app.py:168-204``). Returns True if calibrated; a
    missing or empty folder degrades to dynamic scales with a warning
    rather than refusing to start."""
    calib_dir = config.extras.get("rec_calibrationDir")
    if not (calib_dir and config.rec_quantize):
        return False
    headroom = float(config.extras.get("rec_calibrationHeadroom",
                                       CALIBRATION_HEADROOM))
    try:
        pipeline.calibrate_embedder(
            _load_calibration_crops(calib_dir, config.rec_hw, pixels),
            headroom=headroom)
    except (OSError, ValueError) as e:
        log.warning("int8 calibration skipped (%s); "
                    "using dynamic activation scales", e)
        return False
    log.info("int8 embedder calibrated from %s (headroom %.2f)",
             calib_dir, headroom)
    return True


class FaceServer:
    """Wires config -> embedder -> pipeline -> gallery -> db
    (src/app.cpp:12-106)."""

    def __init__(self, config, rec_params=None, warmup: bool = True,
                 device=None, det_params=None):
        """``rec_params`` / ``det_params``: embedder and detector params in
        facekit's layout; None loads ``config.rec_weights`` /
        ``config.det_weights`` or, without weights, draws random ones with
        numpy (embedder from seed 1, detector of ``det_network`` from seed
        0, RetinaFace with the landmark head when ``det_withLandmarks``). ``device`` defaults to
        ``"cuda"``."""
        refuse_unported(config)
        self.config = config
        self.device = resolve_device(device)
        self.pixels = _Cv2Pixels()
        if rec_params is None:
            rec_params = (load_params(config.rec_weights) if config.rec_weights
                          else random_arcface_params(
                              config.rec_network, seed=1,
                              input_size=config.rec_hw[0],
                              embed_dim=config.rec_outputDim))
        if det_params is None:
            det_params = (load_detector_params(config) if config.det_weights
                          else random_detector_params(config, seed=0))
        self.pipeline = FacePipeline(config, rec_params, det_params,
                                     device=self.device)
        # optional int8 calibration from a folder of face crops: static
        # activation scales replace the per-sample dynamic ones
        self.calibrated = calibrate_from_config(self.pipeline, config,
                                                self.pixels)
        self.db = Database(config.database_path, config.rec_outputDim)
        # micro-batching: each dispatch pads to the smallest bucket of
        # server_batchBuckets that fits the queue (default: one bucket of
        # server_batchSize)
        self.batch_size = int(config.extras.get("server_batchSize", 8))
        raw_buckets = config.extras.get("server_batchBuckets")
        buckets = ([int(b) for b in raw_buckets] if raw_buckets
                   else [self.batch_size])
        self.batch_buckets = sorted(set(buckets))
        self.batch_size = self.batch_buckets[-1]
        self.batch_wait_ms = float(config.extras.get("server_batchWaitMs", 3.0))
        self.gallery = GalleryStore(embed_dim=config.rec_outputDim,
                                    buckets=config.gallery_bucket_sizes,
                                    dtype=config.gallery_dtype,
                                    device=self.device)
        self.user_dict: Dict[str, str] = self.db.get_user_dict()
        self.reload_gallery()
        # one worker: device work serializes on the card anyway
        self.executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        # host decode/resize off the event loop and off the device thread
        self.decode_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(config.extras.get("server_decodeThreads", 4)))
        # enrollment/admin host work (fsync-ing DB commits) gets its own
        # pool so a bulk enrollment cannot starve serving decodes
        self.enroll_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(config.extras.get("server_enrollThreads", 2)))
        self.metrics = LatencyTracker()
        if warmup:
            # builds the kernels and primes both serving paths at every
            # batch bucket, and the enrollment path, so no request pays it
            rh, rw = config.rec_hw
            fh, fw = config.frame_hw
            snap = self.gallery.snapshot()
            for b in self.batch_buckets:
                self.pipeline.embed_and_match(
                    np.zeros((b, rh, rw, 3), np.uint8), snap.arr,
                    max(snap.count, 1), gallery_scale=snap.scales)
                self.pipeline.recognize_and_match(
                    np.zeros((b, fh, fw, 3), np.uint8), snap.arr,
                    max(snap.count, 1), return_crops=True,
                    gallery_scale=snap.scales)
            self.pipeline.embed_cropped(np.zeros((rh, rw, 3), np.uint8))
            if not config.api_imgIsCropped:
                self.pipeline.recognize_frame(np.zeros((fh, fw, 3), np.uint8))

    def close(self) -> None:
        """Stop the worker pools and close the database."""
        for pool in (self.executor, self.decode_pool, self.enroll_pool):
            pool.shutdown(wait=True)
        self.db.close()

    # -- the /recognize batch -------------------------------------------------

    def pad_batch(self, items: List[np.ndarray]) -> np.ndarray:
        """Stack and zero-pad to the smallest batch bucket that fits."""
        target = next(b for b in self.batch_buckets if b >= len(items))
        pad = [np.zeros_like(items[0])] * (target - len(items))
        return np.stack(list(items) + pad)

    def serving_embed(self, crops: np.ndarray, snap):
        """Padded (B, rh, rw, 3) u8 crops -> (emb, sims (B, k), idx)
        against a gallery snapshot, as device tensors."""
        return self.pipeline.embed_and_match(crops, snap.arr, snap.count,
                                             gallery_scale=snap.scales)

    def recognize_batch(self, crops: List[np.ndarray]
                        ) -> List[Optional[Dict[str, Any]]]:
        """The micro-batcher's function: rh x rw BGR crops -> one
        ``{"userId", "similarity"}`` per crop, or None each when the
        gallery is empty."""
        n = len(crops)
        snap = self.gallery.snapshot()
        if snap.count == 0:
            log.warning("Feature matching: No faces in database")
            return [None] * n
        _, vals, idx = self.serving_embed(self.pad_batch(crops), snap)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return [{"userId": snap.names[int(idx[i, 0])],
                 "similarity": float(vals[i, 0])} for i in range(n)]

    # -- the WS /inference batch ----------------------------------------------

    def serving_recognize(self, frames: np.ndarray, snap):
        """Padded (B, fh, fw, 3) u8 frames -> (FrameResult with crops,
        sims (B, F, k), idx (B, F, k)) against a gallery snapshot, as
        device tensors."""
        return self.pipeline.recognize_and_match(
            frames, snap.arr, snap.count, return_crops=True,
            gallery_scale=snap.scales)

    def inference_batch(self, frames: List[np.ndarray]
                        ) -> List[Optional[Dict[str, Any]]]:
        """The WS micro-batcher's function (``facekit/server/app.py:
        915-951``): fh x fw BGR frames -> per frame the best valid face's
        ``{"crop", "userId", "userName", "similarity", "isUnknown"}``, or
        None for a frame with no face and for every frame while the
        gallery is empty."""
        n = len(frames)
        snap = self.gallery.snapshot()
        if snap.count == 0:
            log.warning("Feature matching: No faces in database")
            return [None] * n
        res, sims, gidx = self.serving_recognize(self.pad_batch(frames), snap)
        vals = sims[:n, :, 0].cpu().numpy()
        idx = gidx[:n, :, 0].cpu().numpy()
        valid = res.valid[:n].cpu().numpy()
        best = np.where(valid, vals, -np.inf).argmax(axis=1)        # (n,)
        # one device gather and one transfer for every frame's chosen crop
        sel = res.crops[torch.arange(n, device=res.crops.device),
                        torch.as_tensor(best, device=res.crops.device)]
        crops_u8 = sel.clamp(0, 255).to(torch.uint8).cpu().numpy()
        outs = []
        for i in range(n):
            if not valid[i].any():
                outs.append(None)
                continue
            user_id = snap.names[int(idx[i, best[i]])]
            sim = float(vals[i, best[i]])
            outs.append({
                "crop": crops_u8[i],
                "userId": user_id,
                "userName": self.user_dict.get(user_id, ""),
                "similarity": sim,
                "isUnknown": sim < self.config.rec_knownPersonThreshold,
            })
        return outs

    # -- gallery management (reference /reload, src/app.cpp:354-365) ---------

    def reload_gallery(self) -> int:
        names, embs = self.db.get_embeddings()
        self.gallery.load(names, embs)
        self.user_dict = self.db.get_user_dict()
        log.info("gallery reloaded: %d embeddings", len(names))
        return len(names)

    # -- gen mode (reference src/app.cpp:69-99) -------------------------------

    def enroll_folder(self, source: str, is_cropped: bool = True) -> int:
        """Enroll a ``<source>/<className>/<img>`` tree; returns the count
        of faces inserted (``facekit/server/app.py:631-690``).

        The class name (user id and name) is the subfolder's; files at the
        top level are ignored. Images go through the batched serving path
        in chunks of ``server_batchSize``, zero-padded, decoded on the
        decode pool: crops through ``embed_cropped_batch``, whole images
        through ``recognize_frames``, which must find exactly one face
        (src/app.cpp:171-177) or the image is skipped.
        """
        px = self.pixels
        items = []                                 # (class_name, path)
        for class_name in sorted(os.listdir(source)):
            cdir = os.path.join(source, class_name)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                items.append((class_name, os.path.join(cdir, fname)))

        cfg = self.config
        rh, rw = cfg.rec_hw
        bs = self.batch_size
        count = 0
        for i in range(0, len(items), bs):
            chunk = items[i:i + bs]
            imgs = list(self.decode_pool.map(px.imread,
                                             [p for _, p in chunk]))
            kept = [(cn, p, im) for (cn, p), im in zip(chunk, imgs)
                    if im is not None]
            if not kept:
                continue
            n = len(kept)
            if is_cropped:
                crops = np.zeros((bs, rh, rw, 3), np.uint8)
                for j, (_, _, im) in enumerate(kept):
                    crops[j] = (im if im.shape[:2] == (rh, rw)
                                else px.resize(im, (rw, rh)))
                embs = self.pipeline.embed_cropped_batch(crops)[:n]
                ok = [True] * n
            else:
                frames = np.zeros((bs, cfg.input_frameHeight,
                                   cfg.input_frameWidth, 3), np.uint8)
                for j, (_, _, im) in enumerate(kept):
                    frames[j] = px.resize(im, (cfg.input_frameWidth,
                                               cfg.input_frameHeight))
                res = self.pipeline.recognize_frames(frames)
                valid = res.valid[:n].cpu().numpy()
                embs = res.embeddings[:n, 0].cpu().numpy()
                ok = (valid.sum(axis=1) == 1).tolist()
            for j, (class_name, path, _) in enumerate(kept):
                if not ok[j]:
                    log.warning("no single face in %s; skipped", path)
                    continue
                self.db.insert_user(class_name, class_name)
                self.db.insert_face(class_name, path, embs[j])
                count += 1
        return count


def make_app(server: FaceServer):
    from aiohttp import WSMsgType, web

    from facekit_torch.server.batcher import MicroBatcher, QueueFull

    px = server.pixels
    cfg = server.config

    def run_blocking(fn, *args):
        loop = asyncio.get_running_loop()
        return loop.run_in_executor(server.executor, fn, *args)

    def run_db(fn, *args):
        """SQLite commits fsync: off the event loop, off the device thread
        and off the decode pool."""
        loop = asyncio.get_running_loop()
        return loop.run_in_executor(server.enroll_pool, fn, *args)

    # -- POST /insert/user (src/app.cpp:118-129) ------------------------------
    async def insert_user(request):
        try:
            x = json.loads(await request.text())
            user_id = x["userId"]
            user_name = x["userName"]
        except Exception:
            return web.Response(status=400)
        ret = await run_db(server.db.insert_user, user_id, user_name)
        if ret == 1:
            body = f"Success! User `{user_id}` inserted.\n"
        else:
            body = f"Fail! User `{user_id}` already in database.\n"
        return web.Response(text=body)

    # -- POST /insert/face (src/app.cpp:131-217) ------------------------------
    def _insert_face_sync(body: str) -> str:
        response = ""
        try:
            j = json.loads(body)
        except json.JSONDecodeError:
            return "Please check json input\n"
        if "data" not in j:
            return "Cant find field `data` in input!\n"
        # the try wraps the whole loop (reference src/app.cpp:131-217): a
        # failed element aborts the batch and its error string replaces the
        # accumulated successes; earlier elements' inserts persist
        try:
            for el in j["data"]:
                user_id = el["userId"]
                img_path = el["imgPath"]
                if not os.path.isfile(img_path):
                    raise RuntimeError("Image path not found")
                image = px.imread(img_path)
                if image is None:
                    raise RuntimeError("Image path not found")
                ret = 1
                if cfg.api_imgIsCropped:
                    # host-resize to the recognizer input first (reference
                    # src/app.cpp:148-162 cv::resize)
                    rh_, rw_ = cfg.rec_hw
                    if image.shape[:2] != (rh_, rw_):
                        image = px.resize(image, (rw_, rh_))
                    # only the device call rides the device executor
                    emb = server.executor.submit(
                        server.pipeline.embed_cropped, image).result()
                else:
                    # the whole image through the detector: exactly one
                    # face is enrolled (src/app.cpp:163-186)
                    frame = px.resize(image, (cfg.input_frameWidth,
                                              cfg.input_frameHeight))
                    res = server.executor.submit(
                        server.pipeline.recognize_frame, frame).result()
                    nvalid = int(res.valid.sum())
                    if nvalid > 1:
                        response += ("There are more than 1 faces in input "
                                     f"image from `{img_path}`\n")
                        ret = 2
                    elif nvalid == 0:
                        response += ("Cant find any faces in input image "
                                     f"from `{img_path}`\n")
                        ret = 3
                    else:
                        response += (f"1 face found in input image from "
                                     f"`{img_path}`, processing...\n")
                        emb = res.embeddings[0].cpu().numpy()
                if ret == 1:
                    ret = server.db.insert_face(user_id, img_path, emb)
                if ret == 1:
                    response += (f"Success! Embedding for `{user_id}` "
                                 "inserted successfully.\n")
                else:
                    response += (f"Fail! Embedding for `{user_id}` "
                                 "cannot be inserted.\n")
        except RuntimeError as e:
            log.warning("Exception: %s", e)
            response = f"{e}\n"
        return response

    async def insert_face(request):
        # a non-UTF-8 body must reach the JSON-failure contract path
        try:
            body = (await request.read()).decode("utf-8")
        except UnicodeDecodeError:
            return web.Response(text="Please check json input\n")
        response = await run_db(_insert_face_sync, body)
        return web.Response(text=response)

    # -- GET /delete/user, /delete/face (src/app.cpp:219-241) ----------------
    async def delete_user(request):
        user_id = request.rel_url.query.get("id")
        if user_id is None:
            return web.Response(text="Failed\n")
        await run_db(server.db.delete_user, user_id)
        return web.Response(text="Success\n")

    async def delete_face(request):
        face_id = request.rel_url.query.get("id")
        if face_id is None:
            return web.Response(text="Failed\n")
        await run_db(server.db.delete_face, int(face_id))
        return web.Response(text="Success\n")

    # -- POST /recognize (src/app.cpp:243-287), micro-batched -----------------
    max_queue = int(cfg.extras.get("server_maxQueueDepth",
                                   32 * server.batch_size))
    recognize_batcher = MicroBatcher(server.recognize_batch, server.executor,
                                     server.batch_size, server.batch_wait_ms,
                                     max_queue=max_queue)
    rh, rw = cfg.rec_hw

    def run_decode(data, resize_wh=None):
        """Image bytes -> BGR frame (or None), on the decode pool; the
        queue wait is tracked as /metrics "decode_wait"."""
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()

        def work():
            server.metrics.observe("decode_wait", time.perf_counter() - t0)
            return px.decode(data, resize_wh)
        return loop.run_in_executor(server.decode_pool, work)

    async def recognize(request):
        data = await request.read()
        with server.metrics.time("recognize"):
            # the reference embeds the WHOLE image, no detection
            # (:255-267), host-resizing to the recognizer input first
            frame = await run_decode(data, (rw, rh))
            retval = None
            if frame is not None:
                try:
                    retval = await recognize_batcher.submit(frame)
                except QueueFull:
                    return web.Response(status=503,
                                        text="Server overloaded\n")
        if retval is None:
            return web.Response(text="null",
                                content_type="application/json")
        return web.json_response(retval)

    # -- WS /inference (src/app.cpp:289-352), micro-batched -------------------
    inference_batcher = MicroBatcher(server.inference_batch, server.executor,
                                     server.batch_size, server.batch_wait_ms,
                                     max_queue=max_queue)

    def _encode_reply(out):
        """crop -> base64 JPEG, on the decode pool (host work stays off the
        device executor)."""
        buf = px.encode_jpg(out.pop("crop"))
        out["image"] = base64.b64encode(buf).decode() if buf is not None \
            else ""
        return out

    async def _inference_one(data: bytes) -> str:
        """One WS frame -> reply string. Any per-frame failure (decode, a
        device error out of the batcher, encode) is the contract's "null"
        (src/app.cpp:340-343), so the connection's sender never dies."""
        try:
            with server.metrics.time("inference",
                                     count=cfg.det_maxFacesPerScene):
                frame = await run_decode(
                    data, (cfg.input_frameWidth, cfg.input_frameHeight))
                retval = None
                if frame is not None:
                    try:
                        retval = await inference_batcher.submit(frame)
                    except QueueFull:
                        retval = None
                if retval is not None:
                    loop = asyncio.get_running_loop()
                    retval = await loop.run_in_executor(
                        server.decode_pool, _encode_reply, retval)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("inference frame failed; replying null")
            retval = None
        return "null" if retval is None else json.dumps(retval)

    # frames in flight per connection (1 = the reference's sequential
    # request/reply loop); replies go back in message order
    ws_window = max(1, int(cfg.extras.get("server_wsPipeline", 1)))

    async def inference(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        log.info("Inference socket opened")
        replies: asyncio.Queue = asyncio.Queue()
        sem = asyncio.Semaphore(ws_window)

        async def process(data: bytes) -> str:
            try:
                return await _inference_one(data)
            finally:
                sem.release()

        async def sender():
            while True:
                task = await replies.get()
                if task is None:
                    return
                await ws.send_str(await task)

        sender_task = asyncio.create_task(sender())
        try:
            async for msg in ws:
                if msg.type in (WSMsgType.BINARY, WSMsgType.TEXT):
                    data = (msg.data
                            if isinstance(msg.data, (bytes, bytearray))
                            else msg.data.encode("latin-1"))
                    await sem.acquire()
                    replies.put_nowait(asyncio.create_task(process(data)))
                elif msg.type == WSMsgType.ERROR:
                    break
            replies.put_nowait(None)
            await sender_task
        finally:
            if not sender_task.done():
                sender_task.cancel()
        log.info("Inference socket closed")
        return ws

    # -- GET /reload (src/app.cpp:354-365) ------------------------------------
    async def reload(request):
        await run_db(server.reload_gallery)
        return web.Response(text="Success\n")

    # -- facekit extensions ----------------------------------------------------
    async def search_topk(request):
        """POST /search?k=5 with raw image bytes: top-k gallery matches for
        the whole image embedded as a face."""
        try:
            k = max(1, int(request.rel_url.query.get(
                "k", cfg.gallery_topk or 5)))
        except ValueError:
            return web.Response(status=400, text="invalid k\n")
        if k > 64:    # the search kernel's bound
            return web.Response(status=400, text="k too large (max 64)\n")
        data = await request.read()
        frame = await run_decode(data, (rw, rh))

        def _run():
            if frame is None:
                return None
            emb = server.pipeline.embed_cropped(frame)
            try:
                vals, idx, names = server.gallery.search(
                    emb[None].astype(np.float32), k=k)
            except ValueError:
                return None
            return [{"userId": names[int(idx[0, j])],
                     "userName": server.user_dict.get(
                         names[int(idx[0, j])], ""),
                     "similarity": float(vals[0, j])}
                    for j in range(vals.shape[1])]

        result = await run_blocking(_run)
        if result is None:
            return web.Response(text="null", content_type="application/json")
        return web.json_response({"matches": result})

    async def health(request):
        return web.json_response({
            "status": "ok",
            "gallery_count": server.gallery.count,
            "gallery_capacity": server.gallery.capacity,
            "users": len(server.user_dict),
        })

    # /probe/device (``facekit/server/app.py:1104-1170``): this process's
    # host -> device link, which facekit's loadtest records next to its
    # percentiles. It rides the serving executor on purpose (it measures
    # the queue real dispatches see), so a cooldown bounds how often a
    # poller can stall serving: one probe per server_probeCooldownS.
    probe_state = {"seed": 0, "warm": False, "last": float("-inf")}
    probe_cooldown = float(cfg.extras.get("server_probeCooldownS", 10.0))

    def _sync():
        if server.device.type == "cuda":
            torch.cuda.synchronize(server.device)

    def _probe(n_bytes: int):
        """(upload seconds, round-trip seconds of one tiny op), each
        call on fresh bytes and a fresh operand."""
        dev = server.device
        probe_state["seed"] += 1
        arr = np.random.default_rng(probe_state["seed"]).integers(
            0, 255, n_bytes, dtype=np.uint8)
        t0 = time.perf_counter()
        torch.from_numpy(arr).to(dev, copy=True)
        _sync()
        up_s = time.perf_counter() - t0
        if not probe_state["warm"]:        # first launch, off the clock
            torch.tensor(0.5, device=dev).mul(2.0)
            _sync()
            probe_state["warm"] = True
        t0 = time.perf_counter()
        torch.tensor(float(probe_state["seed"]), device=dev).mul(2.0)
        _sync()
        return up_s, time.perf_counter() - t0

    async def probe_device(request):
        try:
            mb = float(request.query.get("mb", "8"))
        except ValueError:
            return web.Response(status=400, text="invalid mb\n")
        if not (0.125 <= mb <= 64):
            return web.Response(status=400, text="mb out of range\n")
        now = time.monotonic()
        if now - probe_state["last"] < probe_cooldown:
            retry = probe_cooldown - (now - probe_state["last"])
            return web.Response(
                status=429, headers={"Retry-After": f"{max(retry, 1):.0f}"},
                text=f"probe cooldown ({probe_cooldown:.0f}s): the probe "
                     "shares the serving device executor\n")
        probe_state["last"] = now
        n_bytes = int(mb * (1 << 20))
        up_s, rtt_s = await run_blocking(_probe, n_bytes)
        return web.json_response({
            "bytes": n_bytes,
            "upload_s": up_s,
            "upload_MBps": mb / max(up_s, 1e-9),
            "dispatch_ms": rtt_s * 1e3,
            # jax's platform names: "gpu" for a CUDA device
            "platform": "gpu" if server.device.type == "cuda"
            else server.device.type,
        })

    async def metrics(request):
        snap = server.metrics.snapshot()
        for name, b in (("recognize", recognize_batcher),
                        ("inference", inference_batcher)):
            s = snap.setdefault(name, {})
            if b.batches:
                s["mean_batch_size"] = b.items / b.batches
                s["batches"] = b.batches
            s["queue_depth"] = b.depth
            s["shed_count"] = b.sheds
            s["max_queue"] = b.max_queue
        return web.json_response(snap)

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/insert/user", insert_user)
    app.router.add_post("/insert/face", insert_face)
    app.router.add_get("/delete/user", delete_user)
    app.router.add_get("/delete/face", delete_face)
    app.router.add_post("/recognize", recognize)
    app.router.add_get("/inference", inference)
    app.router.add_get("/reload", reload)
    app.router.add_get("/health", health)
    app.router.add_post("/search", search_topk)
    app.router.add_get("/probe/device", probe_device)
    return app


def main(argv=None):
    from facekit_torch.config import load_config

    ap = argparse.ArgumentParser("facekit_torch server")
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--db", default=None)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu to "
                         "run on the CPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config) if args.config else load_config({})
    if args.db:
        import dataclasses
        cfg = dataclasses.replace(cfg, database_path=args.db)
    device = resolve_device(args.device)
    server = FaceServer(cfg, warmup=not args.no_warmup, device=device)
    if cfg.gen:  # batch-enrollment mode, then exit (src/app.cpp:69-99)
        try:
            n = server.enroll_folder(cfg.gen_imgSource, cfg.gen_imgIsCropped)
        finally:
            server.close()
        log.info("Database generated (%d faces). Exiting...", n)
        return
    app = make_app(server)
    from aiohttp import web
    web.run_app(app, port=args.port or cfg.server_port)


if __name__ == "__main__":
    main()
