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

With ``--engines DIR`` (``extras.server_enginesDir``) WS ``/inference``
and ``/recognize`` run the exported engines of ``facekit_torch.engine``
and then the gallery match; enrollment stays eager. On a mesh the
directory's identify engines serve WS ``/inference``, the whole
transaction with the match in one program (``facekit/server/app.py:
286-315``): the gallery's capacity is pinned to the engines' frozen rows
and a ``/reload`` past it is refused while the old gallery keeps
serving; ``/recognize`` stays eager on the mesh, as in facekit.

With ``mesh_shape`` (``{"data": D, "gallery": G}``, either axis optional,
``"gallery"`` 1 when absent) one process serves on a mesh of every local
GPU (``facekit/server/app.py:246-273``): the gallery rows shard over
``"gallery"``, each batch splits over ``"data"`` (the batch buckets are
rounded up to multiples of D), and results gather on the mesh's first
device, where enrollment runs. A mesh that needs more GPUs than there are
is refused at start; with ``device="cpu"`` the CPU stands at every
position.

Host pixel work (decode, resize, the reply's JPEG) uses OpenCV, or the
port's native C++ runtime (``facekit_torch.native``) when cv2 is missing
or ``extras.server_hostOps`` is "native" (``host_pixels``). A config that
asks for a live profiler server is refused at startup
(``refuse_unported``).
With ``rec_quantize`` the server calibrates the int8 embedder from
``extras.rec_calibrationDir`` at startup (``calibrate_from_config``),
with ``extras.rec_int8Residual`` into the int8-residual embedder. Device
work runs on one executor thread; the kernels launch on the device's
current stream.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import concurrent.futures
import json
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from facekit_torch.db import Database
from facekit_torch.engine import (engine_states, load_identify_engines,
                                  load_serving_engines)
from facekit_torch.gallery import GalleryStore
from facekit_torch.parallel import make_mesh
from facekit_torch.pipeline import FacePipeline
from facekit_torch.pipeline.recognize import (CALIBRATION_HEADROOM,
                                              FrameResult, _own_frames)
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


class _NativePixels:
    """Host pixel backend over the port's native runtime (libjpeg and the
    native resize, ``facekit/server/app.py:84-120``). JPEG decode is
    bit-identical to cv2's (the same libjpeg family), resize within 1 LSB.
    A JPEG-only codec: other formats decode to None, the contract's
    failure path."""

    name = "native"

    def __init__(self):
        from facekit_torch import native
        if not native.available():
            raise RuntimeError("native host backend unavailable: "
                               f"{native.build_error()}")
        self.native = native

    def decode(self, data: bytes, resize_wh=None):
        return self.native.decode_jpeg_bgr(data, resize_wh)

    def imread(self, path: str, resize_wh=None):
        try:
            with open(path, "rb") as f:
                return self.decode(f.read(), resize_wh)
        except OSError:
            return None

    def resize(self, img, wh):
        w, h = wh
        return self.native.resize_u8(
            np.ascontiguousarray(img, np.uint8), (h, w), "linear",
            saturate=True).astype(np.uint8)

    def encode_jpg(self, img) -> Optional[bytes]:
        return self.native.encode_jpeg_bgr(
            np.clip(np.asarray(img), 0, 255).astype(np.uint8))


def host_pixels(config):
    """The host pixel backend of ``config`` (``facekit/server/app.py:
    123-139``): cv2 when importable, the native runtime when cv2 is
    missing or when forced with ``extras.server_hostOps: "native"``. A
    native backend that cannot be built raises."""
    if config.extras.get("server_hostOps") != "native":
        try:
            return _Cv2Pixels()
        except ImportError:
            # loud: the native backend decodes JPEG only, so PNG frames
            # and enrollment files would fail like corrupt input
            log.warning("cv2 not importable; host pixel work falls back "
                        "to the native backend (decodes JPEG only: PNG "
                        "inputs will decode as None)")
    return _NativePixels()


def refuse_unported(config) -> None:
    """Raise for a config that asks for a live profiler server: torch has
    none to attach to (``facekit_torch.utils.profile_trace`` writes a
    trace instead)."""
    if config.extras.get("profiler_port"):
        raise ValueError(
            "config needs parts facekit_torch has not ported: "
            "profiler_port (a live profiler server) is not ported: torch "
            "has no attachable profiler server; "
            "facekit_torch.utils.profile_trace writes a trace")


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


def model_params(config, rec_params=None, det_params=None):
    """(rec_params, det_params) a server of ``config`` serves: those given,
    else ``config.rec_weights`` / ``config.det_weights``, else random ones
    drawn with numpy (embedder from seed 1, detector of ``det_network``
    from seed 0, RetinaFace with the landmark head when
    ``det_withLandmarks``)."""
    if rec_params is None:
        rec_params = (load_params(config.rec_weights) if config.rec_weights
                      else random_arcface_params(
                          config.rec_network, seed=1,
                          input_size=config.rec_hw[0],
                          embed_dim=config.rec_outputDim))
    if det_params is None:
        det_params = (load_detector_params(config) if config.det_weights
                      else random_detector_params(config, seed=0))
    return rec_params, det_params


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
    rather than refusing to start, except with ``extras.rec_int8Residual``,
    which has no dynamic mode: then a missing calibration raises."""
    calib_dir = config.extras.get("rec_calibrationDir")
    residual = bool(config.extras.get("rec_int8Residual", False))
    if not (calib_dir and config.rec_quantize):
        if residual:
            # the flag is read only by the calibration: without one the
            # server would serve dynamic int8 while the operator believes
            # residual mode is on
            raise ValueError(
                "rec_int8Residual requires rec_quantize AND "
                "rec_calibrationDir (s8-resident residuals need "
                "calibrated per-block output scales)")
        return False
    headroom = float(config.extras.get("rec_calibrationHeadroom",
                                       CALIBRATION_HEADROOM))
    try:
        pipeline.calibrate_embedder(
            _load_calibration_crops(calib_dir, config.rec_hw, pixels),
            headroom=headroom)
    except (OSError, ValueError) as e:
        if residual:    # degrading would silently drop residual mode
            raise
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
                 device=None, det_params=None, engines_dir=None):
        """``rec_params`` / ``det_params``: embedder and detector params in
        facekit's layout; None loads them as ``model_params`` does.
        ``device`` defaults to ``"cuda"``; with ``config.mesh_shape`` the
        server's device becomes the mesh's first (see the module
        docstring). ``engines_dir`` (or
        ``extras.server_enginesDir``): serve WS /inference and /recognize
        from the engines exported there (``python -m facekit_torch.engine
        export``), one recognize / embed pair per batch bucket, or with
        ``mesh_shape`` one identify engine per bucket; the enrollment
        paths stay eager."""
        refuse_unported(config)
        self.config = config
        self.device = resolve_device(device)
        self.mesh = None
        if config.mesh_shape:
            # the gallery rows shard over "gallery", the batch over
            # "data"; a missing gallery axis is size 1 (pure data)
            shape = dict(config.mesh_shape)
            shape.setdefault("gallery", 1)
            self.mesh = make_mesh(shape, devices=(
                [self.device] * math.prod(shape.values())
                if self.device.type == "cpu" else None))
            self.device = self.mesh.home
        self.pixels = host_pixels(config)
        rec_params, det_params = model_params(config, rec_params, det_params)
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
        if self.mesh is not None and "data" in self.mesh.shape:
            # padded batches split over the data axis: keep them divisible
            d = self.mesh.shape["data"]
            buckets = [-(-b // d) * d for b in buckets]
        self.batch_buckets = sorted(set(buckets))
        self.batch_size = self.batch_buckets[-1]
        self.batch_wait_ms = float(config.extras.get("server_batchWaitMs", 3.0))
        # engine-served mode (facekit/server/app.py:283-335): the hot-path
        # programs come from exported files, checked against this config
        # and pipeline; the gallery match runs after them, so the engines
        # freeze no gallery and /reload works as in eager mode
        engines_dir = engines_dir or config.extras.get("server_enginesDir")
        self.engines = None
        self.identify_engines = None
        gallery_buckets = config.gallery_bucket_sizes
        if engines_dir and self.mesh is not None:
            # identify engines: the whole sharded transaction, frozen at
            # one gallery capacity, which the bucket ladder is pinned to
            self.identify_engines = load_identify_engines(
                engines_dir, config, self.pipeline, self.mesh,
                self.batch_buckets)
            self._identify_states = {
                b: self.identify_engines[b].states(self.pipeline)
                for b in self.batch_buckets}
            frozen = next(iter(self.identify_engines.values())).gallery_rows
            gallery_buckets = (frozen,)
            log.info("serving identify from engines in %s (batch buckets "
                     "%s, gallery capacity %d)", engines_dir,
                     sorted(self.identify_engines), frozen)
        elif engines_dir:
            self.engines = load_serving_engines(
                engines_dir, config, self.pipeline, self.batch_buckets)
            self._det_state, self._rec_state = engine_states(self.pipeline)
            log.info("serving from engines in %s (batch buckets %s)",
                     engines_dir, self.batch_buckets)
        self.gallery = GalleryStore(embed_dim=config.rec_outputDim,
                                    buckets=gallery_buckets,
                                    dtype=config.gallery_dtype,
                                    device=self.device, mesh=self.mesh)
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
            # builds the kernels and primes both serving paths (engines
            # and the match at both query shapes, or the eager programs)
            # at every batch bucket, and the enrollment path, so no
            # request pays it
            rh, rw = config.rec_hw
            fh, fw = config.frame_hw
            snap = self.gallery.snapshot()
            snap = snap._replace(count=max(snap.count, 1))
            for b in self.batch_buckets:
                self.serving_embed(np.zeros((b, rh, rw, 3), np.uint8), snap)
                self.serving_recognize(np.zeros((b, fh, fw, 3), np.uint8),
                                       snap)
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
        against a gallery snapshot, as device tensors: the embed engine of
        batch B and the match, or the eager pipeline."""
        if self.engines is None:
            return self.pipeline.embed_and_match(crops, snap.arr, snap.count,
                                                 gallery_scale=snap.scales,
                                                 mesh=self.mesh)
        fn = self.engines["embed"][crops.shape[0]]
        with torch.inference_mode():
            emb = fn(self._rec_state, _own_frames(crops, self.device))
        vals, idx = self.pipeline.match_flat(emb, snap.arr, snap.count,
                                             gallery_scale=snap.scales)
        return emb, vals, idx

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
        device tensors: on a mesh served from engines the identify
        engine of batch B, the match inside it (``facekit/server/app.py:
        563-569``); else the recognize engine of batch B and the match
        (``:571-586``), or the eager pipeline."""
        if self.identify_engines is not None:
            b = frames.shape[0]
            boxes, scores, valid, emb, vals, idx, crops = \
                self.identify_engines[b](
                    *self._identify_states[b], snap.arr, snap.count, frames,
                    gallery_scale=snap.scales)
            return FrameResult(boxes, scores, valid, emb, None, crops), \
                vals, idx
        if self.engines is None:
            return self.pipeline.recognize_and_match(
                frames, snap.arr, snap.count, return_crops=True,
                gallery_scale=snap.scales, mesh=self.mesh)
        fn = self.engines["recognize"][frames.shape[0]]
        with torch.inference_mode():
            boxes, scores, valid, emb, crops = fn(
                self._det_state, self._rec_state,
                _own_frames(frames, self.device))
        vals, idx = self.pipeline.match_flat(emb, snap.arr, snap.count,
                                             gallery_scale=snap.scales)
        return FrameResult(boxes, scores, valid, emb, None, crops), vals, idx

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
        if self.identify_engines is not None:
            # the identify engines froze the capacity: refuse here, before
            # the swap, so the old gallery keeps serving
            frozen = next(iter(self.identify_engines.values())).gallery_rows
            if self.gallery.capacity_for(len(names)) != frozen:
                raise ValueError(
                    f"gallery has {len(names)} rows but the identify "
                    f"engines are frozen at capacity {frozen}; re-export "
                    f"with --gallery-rows >= {len(names)}")
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
    ap.add_argument("--engines", default=None, metavar="DIR",
                    help="serve WS /inference and /recognize from the "
                         "engines in DIR (python -m facekit_torch.engine "
                         "export); also settable as extras.server_enginesDir")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config) if args.config else load_config({})
    if args.db:
        import dataclasses
        cfg = dataclasses.replace(cfg, database_path=args.db)
    device = resolve_device(args.device)
    server = FaceServer(cfg, warmup=not args.no_warmup, device=device,
                        engines_dir=args.engines)
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
