"""The detect -> crop/align -> embed -> match pipeline.

Port of ``facekit/pipeline/recognize.py``. PyTorch runs eagerly, so each
method is the body of one of facekit's jitted programs:

    letterbox + det_normalize -> detector -> decode + NMS (max_faces
        slots per frame) -> 5-point alignment (or cubic crop-resize)
        -> rec_normalize -> ArcFace -> gallery search

  * ``detect_frames`` (``_detect_frames``, ``:168-189``), frames ->
    ``Detections``;
  * ``recognize_frame(s)`` (``:89-165``) -> ``FrameResult``;
  * ``recognize_and_match`` (``:262-297``), the WS ``/inference`` batch:
    frames -> (FrameResult, sims (N, F, k), gallery idx (N, F, k));
  * ``embed_and_match`` / ``embed_cropped(_batch)`` (``:304-354``), the
    ``/recognize`` and enrollment path on pre-cropped faces.

The detector runs when ``det_params`` are given: RetinaFace, or with
``det_network`` slim / rfb the light detector ``LightDet`` and its
anchors (``:60-77``); with ``det_quantize`` it is the int8 detector
(``models.quantize_detector``, before it moves to the device,
``:369-371``). Landmarks are used when the params carry a landmark head
(``ldm_head`` or the light detectors' ``landm``), and alignment when
landmarks are used and the config sets ``rec_useAlignment``
(``:383-388``). With ``rec_quantize``
the embedder is the int8 ArcFace, dynamic until ``calibrate_embedder``
fixes its activation scales; the float weights stay on the host for that
(``:373-416``). An int8 gallery is searched with the f32 embeddings
(``_match_queries``, ``:208-225``).

On a device mesh (``parallel.Mesh``; ``mesh=`` of ``recognize_and_match``,
``embed_and_match`` and ``match_flat``, ``:192-252``) the batch splits
over the mesh's ``"data"`` axis where its size divides the batch
(``_mesh_data_axis``, one predicate for frames and queries): each data
position runs detect -> align -> embed on its own replica of the
networks (made once per device from the served ones; a device that
stands at several positions reuses its replica), and the outputs are
concatenated in frame order on the pipeline's device. The match goes to
``parallel.sharded_cosine_topk`` over the gallery's shards, the queries
split over ``"data"`` where it divides them (``_match_queries``).

The bodies of the serving programs are module functions of the
networks and the frames, ``recognize_program`` and ``embed_program``
(with ``detector_program``), and ``identify_program``, the whole
``recognize_and_match`` transaction on one device or a mesh: the eager
methods call them under inference mode, and ``facekit_torch.engine``
traces the same functions into its exported engines, the networks run
on a state given as input.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from facekit_torch.config import FaceKitConfig
from facekit_torch.models.arcface import (ArcFace, calibrate_arcface_int8,
                                          quantize_arcface)
from facekit_torch.models.detector import detector_family
from facekit_torch.models.retinaface import quantize_detector
from facekit_torch.ops.align import warp_align_frames
from facekit_torch.ops.anchors import generate_anchors
from facekit_torch.ops.boxes import Detections, select_faces_batch
from facekit_torch.ops.preprocess import det_normalize, rec_normalize
from facekit_torch.ops.resize import crop_resize, letterbox, resize_image
from facekit_torch.ops.similarity import cosine_topk, cosine_topk_int8
from facekit_torch.parallel import canonical, sharded_cosine_topk
from facekit_torch.utils.device import resolve_device
from facekit_torch.weights.bridge import from_jax

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: default int8-calibration headroom of every entry point
#: (``facekit/pipeline/recognize.py:39-43``)
CALIBRATION_HEADROOM = 1.25


def _own_frames(arr, device: torch.device) -> torch.Tensor:
    """Device tensor from a possibly caller-owned host buffer.

    ``torch.from_numpy`` (and ``as_tensor``) alias the numpy buffer, which
    the caller may overwrite while the work that reads it is still queued
    (``facekit/pipeline/recognize.py:46-57``); ``torch.tensor`` copies."""
    if isinstance(arr, np.ndarray):
        return torch.tensor(arr, device=device)
    return torch.as_tensor(arr, device=device)


def _detector(config: FaceKitConfig, det_params, device):
    """The float f32 detector of ``config.det_network`` with ``det_params``
    carried over, and its anchors on ``device``."""
    family = detector_family(config.det_network)
    det = family.build(det_params)
    anchors = generate_anchors(config.det_hw, family.steps, family.min_sizes,
                               device=device)
    det.load_state_dict(from_jax(det_params, det))
    return det, anchors


class FrameResult(NamedTuple):
    boxes: torch.Tensor        # (..., F, 4) frame pixels
    scores: torch.Tensor       # (..., F)
    valid: torch.Tensor        # (..., F) bool
    embeddings: torch.Tensor   # (..., F, D) L2-normalized (garbage if invalid)
    landmarks: Optional[torch.Tensor] = None   # (..., F, 5, 2) or None
    crops: Optional[torch.Tensor] = None       # (..., F, rh, rw, 3) f32 BGR


class FacePipeline:
    """Owns the detector and the embedder for one config, on one device."""

    def __init__(self, config: FaceKitConfig, rec_params: Dict[str, Any],
                 det_params: Optional[Dict[str, Any]] = None, device=None):
        """``rec_params`` / ``det_params``: the embedder's and detector's
        params in facekit's layout (what ``facekit.models.arcface_init`` /
        ``retinaface_init``, ``weights.load_params`` or
        ``weights.random_*_params`` return), carried over by
        ``weights.bridge.from_jax``. Without ``det_params`` only the
        pre-cropped methods work. ``device`` defaults to ``"cuda"``."""
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products and convs in full f32, not TF32 (these are
            # process-wide switches; facekit's f32 compute is full f32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = _COMPUTE_DTYPES[config.compute_dtype]
        net = ArcFace(config.rec_network, input_size=config.rec_hw[0],
                      embed_dim=config.rec_outputDim)
        net.load_state_dict(from_jax(rec_params, net))
        # the float f32 embedder on the host, for calibrate_embedder: a
        # copy on the card would sit beside the int8 one for good
        self._rec_net_float: Optional[ArcFace] = None
        if config.rec_quantize:
            self._rec_net_float = net.eval()
            net = quantize_arcface(net)
        self._serve(net)

        self.det_net = None
        self.use_landmarks = False
        if det_params is not None:
            det, self.anchors = _detector(config, det_params, self.device)
            if config.det_quantize:
                det = quantize_detector(det)
            self.det_net = det.set_compute_dtype(self.dtype).to(
                self.device).eval()
            self.use_landmarks = ("ldm_head" in det_params
                                  or "landm" in det_params)
        self.align = self.use_landmarks and bool(
            config.extras.get("rec_useAlignment", False))

    def _serve(self, net: ArcFace) -> None:
        self.rec_net = net.set_compute_dtype(self.dtype).to(self.device).eval()
        # the other devices' replicas, made from the served networks
        self._replicas: Dict[torch.device, tuple] = {}

    def _replica(self, device):
        """(det_net, rec_net, anchors) on ``device``: the served ones on
        the pipeline's device, else copies made at first use."""
        dev = canonical(device)
        if dev == canonical(self.device):
            return self.det_net, self.rec_net, getattr(self, "anchors", None)
        if dev not in self._replicas:
            # made outside inference mode (the first use is inside it):
            # inference tensors carry no version counter, which the fused
            # blocks' operand cache keys on
            with torch.inference_mode(False):
                det = (None if self.det_net is None
                       else copy.deepcopy(self.det_net).to(dev))
                anchors = (None if self.det_net is None
                           else self.anchors.to(dev))
                self._replicas[dev] = (
                    det, copy.deepcopy(self.rec_net).to(dev), anchors)
        return self._replicas[dev]

    def calibrate_embedder(self, crop_batches: Iterable,
                           headroom: float = CALIBRATION_HEADROOM) -> None:
        """Switch the int8 embedder from dynamic to calibrated static
        activation scales (requires ``rec_quantize``).

        ``crop_batches``: (N, rec_h, rec_w, 3) BGR face-crop batches,
        normalized as the serving path normalizes them; the float f32
        embedder runs on them on the device, each site's activation maxima
        are folded over all batches, and the int8 embedder is rebuilt with
        static scales (``facekit/pipeline/recognize.py:390-416``), in the
        int8-residual form with ``extras.rec_int8Residual``.
        """
        if not self.config.rec_quantize:
            raise ValueError("calibrate_embedder requires rec_quantize")
        float_net = copy.deepcopy(self._rec_net_float).to(self.device)
        batches = (rec_normalize(_own_frames(b, self.device).float())
                   for b in crop_batches)
        net = calibrate_arcface_int8(
            float_net, batches, headroom=headroom,
            int8_residual=bool(self.config.extras.get("rec_int8Residual",
                                                      False)))
        del float_net
        self._serve(net)

    # -- detection ------------------------------------------------------------

    @torch.inference_mode()
    def _detector_outputs(self, frames: torch.Tensor):
        """(N, fh, fw, 3) BGR frames on the device -> the detector's (loc,
        conf, ldm) on the letterboxed, normalized frames."""
        return detector_program(self, self.det_net, frames)

    def _select_faces(self, loc, conf, ldm) -> Detections:
        """Detector outputs -> Detections with max_faces slots per frame,
        on the device the outputs lie on."""
        cfg = self.config
        anchors = (self.anchors if loc.device == self.anchors.device
                   else self._replica(loc.device)[2])
        return select_faces_batch(
            loc, conf, anchors, cfg.frame_hw, cfg.det_hw,
            max_faces=cfg.det_maxFacesPerScene,
            score_threshold=cfg.det_threshold_bbox,
            iou_threshold=cfg.det_threshold_nms, nms_top_k=cfg.det_nmsTopK,
            nms_exact=cfg.det_nmsExact,
            ldm=ldm if self.use_landmarks else None)

    @torch.inference_mode()
    def _detect(self, frames: torch.Tensor) -> Detections:
        return self._select_faces(*detector_program(self, self.det_net,
                                                    frames))

    def detect_frames(self, frames_bgr) -> Detections:
        """Detection only: (N, H, W, 3) BGR frames -> Detections (boxes,
        scores, valid, landmarks) in frame pixels, as device tensors."""
        return self._detect(_own_frames(frames_bgr, self.device))

    @torch.inference_mode()
    def _recognize_frames(self, frames: torch.Tensor, return_crops: bool
                          ) -> FrameResult:
        return recognize_program(self, self.det_net, self.rec_net, frames,
                                 return_crops)

    def recognize_frames(self, frames_bgr, return_crops: bool = False
                         ) -> FrameResult:
        """Batched path: (N, fh, fw, 3) BGR frames -> FrameResult with a
        leading N; all N * max_faces crops embed in one ArcFace call."""
        return self._recognize_frames(_own_frames(frames_bgr, self.device),
                                      return_crops)

    def recognize_frame(self, frame_bgr, return_crops: bool = False
                        ) -> FrameResult:
        """One (fh, fw, 3) BGR frame -> FrameResult without the batch axis
        (the same numbers as a batch of one, as in facekit)."""
        res = self._recognize_frames(
            _own_frames(frame_bgr, self.device)[None], return_crops)
        return FrameResult(*(None if t is None else t[0] for t in res))

    @torch.inference_mode()
    def _split(self, program, host, mesh, data_axis):
        """``program(det_net, rec_net, x)`` over a batch (``_over_data``):
        each slice on its data position's device and replica of the
        networks, the host slice copied there (facekit's
        ``_constrain_batch``)."""
        return _over_data(
            lambda j, dev, lo, hi: program(*self._replica(dev)[:2],
                                           _own_frames(host[lo:hi], dev)),
            len(host), mesh, data_axis, canonical(self.device))

    def recognize_and_match(self, frames_bgr, gallery_arr: torch.Tensor,
                            count: int, k: int = 1,
                            return_crops: bool = False,
                            gallery_scale: Optional[torch.Tensor] = None,
                            mesh=None, gallery_axis: str = "gallery",
                            data_axis: str = "data"):
        """Frames -> (FrameResult, sims (N, F, k), gallery idx (N, F, k)):
        the WS ``/inference`` batch, ``identify_program`` on the served
        networks (and their replicas on a mesh). Pass the fields of a
        ``GalleryStore.snapshot()`` (and the store's mesh for a sharded
        one); an int8 gallery needs its scales."""
        with torch.inference_mode():
            return identify_program(
                self, lambda j, dev: self._replica(dev)[:2], gallery_arr,
                count, _own_frames(frames_bgr, self.device), return_crops,
                k, gallery_scale, mesh, gallery_axis, data_axis)

    # -- pre-cropped faces ----------------------------------------------------

    @torch.inference_mode()
    def _embed(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, rec_h, rec_w, 3) BGR on the device -> (N, D) f32."""
        return embed_program(self.rec_net, imgs)

    @torch.inference_mode()
    def match_flat(self, flat_embeddings, gallery_arr: torch.Tensor,
                   count: int, k: int = 1,
                   gallery_scale: Optional[torch.Tensor] = None,
                   mesh=None, gallery_axis: str = "gallery",
                   data_axis: str = "data"):
        """Gallery match only: (..., D) embeddings -> (sims (..., k), idx)
        (``_match_queries``)."""
        flat = torch.as_tensor(flat_embeddings, device=self.device)
        lead = flat.shape[:-1]
        vals, idx = _match_queries(gallery_arr, gallery_scale,
                                   flat.reshape(-1, flat.shape[-1]), count,
                                   k, mesh, gallery_axis, data_axis)
        return vals.reshape(*lead, -1), idx.reshape(*lead, -1)

    def embed_and_match(self, imgs_bgr, gallery_arr: torch.Tensor,
                        count: int, k: int = 1,
                        gallery_scale: Optional[torch.Tensor] = None,
                        mesh=None, gallery_axis: str = "gallery",
                        data_axis: str = "data"):
        """(N, rec_h, rec_w, 3) crops -> (emb (N, D), sims (N, k), idx);
        ``mesh`` as in ``recognize_and_match``."""
        emb = self._split(lambda det, rec, x: embed_program(rec, x),
                          imgs_bgr, mesh, data_axis)
        vals, idx = self.match_flat(emb, gallery_arr, count, k, gallery_scale,
                                    mesh, gallery_axis, data_axis)
        return emb, vals, idx

    @torch.inference_mode()
    def embed_cropped(self, img_bgr) -> np.ndarray:
        """Embed an already-cropped (H, W, 3) BGR face of any size (resized
        with OpenCV's linear semantics when it is not the input size)."""
        img = _own_frames(img_bgr, self.device).float()
        if tuple(img.shape[:2]) != self.config.rec_hw:
            img = resize_image(img, self.config.rec_hw, "linear",
                               saturate=True)
        return self._embed(img[None])[0].cpu().numpy()

    def embed_cropped_batch(self, imgs_bgr) -> np.ndarray:
        """(N, rec_h, rec_w, 3) BGR pre-resized crops -> (N, D)."""
        return self._embed(_own_frames(imgs_bgr, self.device)).cpu().numpy()


def _over_data(run, n: int, mesh, data_axis, home: torch.device):
    """``run(j, dev, lo, hi)`` over a batch of ``n``: once on ``home`` for
    all of it (j = 0), or, where ``_mesh_data_axis`` allows, once per data
    position j for its slice [lo, hi) on the position's device. The
    outputs (a tensor or a tuple of tensors and Nones) are concatenated
    in batch order on ``home``."""
    devs = data_devices(mesh, data_axis, n, home)
    if len(devs) == 1:
        return run(0, home, 0, n)
    m = n // len(devs)
    outs = [run(j, dev, j * m, (j + 1) * m) for j, dev in enumerate(devs)]

    def cat(parts):
        return torch.cat([p.to(home) for p in parts])
    if isinstance(outs[0], torch.Tensor):
        return cat(outs)
    return type(outs[0])(*(None if parts[0] is None else cat(parts)
                           for parts in zip(*outs)))


def data_devices(mesh, data_axis, n: int, home: torch.device):
    """The device of each position ``_over_data`` runs a batch of ``n``
    on, in its order: ``home`` alone where ``_mesh_data_axis`` does not
    split the batch. An exported program's states line up with it."""
    axis = _mesh_data_axis(mesh, data_axis, n)
    if axis is None:
        return [home]
    return [canonical(mesh.device_at(**{axis: j}))
            for j in range(mesh.shape[axis])]


def _mesh_data_axis(mesh, data_axis, batch: int):
    """The mesh axis a leading dim of ``batch`` splits over, or None when
    the mesh or the axis is absent, of size 1, or does not divide it
    (``facekit/pipeline/recognize.py:228-242``). One predicate for the
    frame batch and the query batch, which differ (N frames, N * F
    queries): queries can split where a small frame batch cannot."""
    if (mesh is None or data_axis is None or data_axis not in mesh.shape
            or mesh.shape[data_axis] <= 1
            or batch % mesh.shape[data_axis] != 0):
        return None
    return data_axis


def _match_queries(gallery, gallery_scale, flat: torch.Tensor, count: int,
                   k: int, mesh=None, gallery_axis: str = "gallery",
                   data_axis: str = "data"):
    """A (B, D) query batch to the search of its gallery
    (``facekit/pipeline/recognize.py:192-225``), {one device, mesh} x
    {float, int8}: an int8 gallery (with its per-row ``gallery_scale``)
    takes the f32 queries, a float one the queries cast to its dtype; a
    mesh's sharded gallery goes to ``sharded_cosine_topk``, the queries
    split over ``data_axis`` where it divides them."""
    quantized = gallery.dtype == torch.int8
    q = (flat.float() if quantized else flat.to(gallery.dtype)).contiguous()
    if mesh is not None:
        return sharded_cosine_topk(
            gallery, q, count, k, mesh=mesh, axis=gallery_axis,
            query_axis=_mesh_data_axis(mesh, data_axis, q.shape[0]),
            scales=gallery_scale)
    if quantized:
        return cosine_topk_int8(gallery, gallery_scale, q, count, k)
    return cosine_topk(gallery, q, count, k)


# -- the serving programs, shared by the eager methods above and the
#    engines (``facekit_torch.engine``), which trace them with
#    ``torch.func.functional_call`` modules; no inference mode inside

def detector_program(pipe: FacePipeline, det_net, frames: torch.Tensor):
    """(N, fh, fw, 3) BGR frames -> ``det_net``'s (loc, conf, ldm) on the
    letterboxed, normalized frames, at ``pipe``'s config."""
    if det_net is None:
        raise ValueError("this pipeline has no detector (det_params)")
    return det_net(det_normalize(letterbox(frames.float(),
                                           pipe.config.det_hw)))


def recognize_program(pipe: FacePipeline, det_net, rec_net,
                      frames: torch.Tensor, return_crops: bool
                      ) -> FrameResult:
    """facekit's ``_recognize_frames`` (``:191-204``): detect, align (or
    crop), embed all N * max_faces faces in one call of ``rec_net``. The
    statics (geometry, thresholds, alignment, dtype) and the anchors come
    from ``pipe``; the networks are arguments, so an export can pass
    them over a state given as input."""
    det = pipe._select_faces(*detector_program(pipe, det_net, frames))
    n, nf = det.valid.shape
    if pipe.align:
        faces = warp_align_frames(frames, det.landmarks, pipe.config.rec_hw,
                                  dtype=pipe.dtype)
    else:
        faces = crop_resize(frames.float(), det.boxes, pipe.config.rec_hw,
                            "cubic")
    flat = faces.reshape(n * nf, *faces.shape[2:])
    emb = rec_net(rec_normalize(flat)).reshape(n, nf, -1)
    return FrameResult(det.boxes, det.scores, det.valid, emb,
                       det.landmarks, faces if return_crops else None)


def embed_program(rec_net, imgs: torch.Tensor) -> torch.Tensor:
    """(N, rec_h, rec_w, 3) BGR crops -> (N, D) f32 embeddings."""
    return rec_net(rec_normalize(imgs.float()))


def identify_program(pipe: FacePipeline, nets, gallery, count,
                     frames: torch.Tensor, return_crops: bool, k: int = 1,
                     gallery_scale=None, mesh=None,
                     gallery_axis: str = "gallery", data_axis: str = "data"):
    """The whole WS ``/inference`` transaction, facekit's
    ``_recognize_and_match`` (``:262-297``): (N, fh, fw, 3) frames on the
    pipeline's device -> (FrameResult, sims (N, F, k), idx (N, F, k)).

    ``nets(j, dev)`` gives data position j's (det_net, rec_net) on
    ``dev``. Without ``mesh`` this is ``recognize_program`` and the
    single-device search; with one, the frames split over ``data_axis``
    as ``_over_data`` splits them, and the match goes to the row-sharded
    search over ``gallery`` (a ``ShardedRows``; ``gallery_scale`` too for
    an int8 gallery). ``count`` is an int, or in an exported identify
    engine a SymInt the program computes each shard's live rows from.
    The eager ``recognize_and_match`` runs this function and
    ``engine.export_identify_engine`` traces it."""
    res = _over_data(
        lambda j, dev, lo, hi: recognize_program(
            pipe, *nets(j, dev), frames[lo:hi].to(dev), return_crops),
        frames.shape[0], mesh, data_axis, frames.device)
    n, f, d = res.embeddings.shape
    vals, idx = _match_queries(gallery, gallery_scale,
                               res.embeddings.reshape(n * f, d), count, k,
                               mesh, gallery_axis, data_axis)
    return res, vals.reshape(n, f, -1), idx.reshape(n, f, -1)
