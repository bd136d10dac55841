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

    def calibrate_embedder(self, crop_batches: Iterable,
                           headroom: float = CALIBRATION_HEADROOM) -> None:
        """Switch the int8 embedder from dynamic to calibrated static
        activation scales (requires ``rec_quantize``).

        ``crop_batches``: (N, rec_h, rec_w, 3) BGR face-crop batches,
        normalized as the serving path normalizes them; the float f32
        embedder runs on them on the device, each site's activation maxima
        are folded over all batches, and the int8 embedder is rebuilt with
        static scales (``facekit/pipeline/recognize.py:390-416``).
        """
        if not self.config.rec_quantize:
            raise ValueError("calibrate_embedder requires rec_quantize")
        float_net = copy.deepcopy(self._rec_net_float).to(self.device)
        batches = (rec_normalize(_own_frames(b, self.device).float())
                   for b in crop_batches)
        net = calibrate_arcface_int8(float_net, batches, headroom=headroom)
        del float_net
        self._serve(net)

    # -- detection ------------------------------------------------------------

    @torch.inference_mode()
    def _detector_outputs(self, frames: torch.Tensor):
        """(N, fh, fw, 3) BGR frames on the device -> the detector's (loc,
        conf, ldm) on the letterboxed, normalized frames."""
        if self.det_net is None:
            raise ValueError("this pipeline has no detector (det_params)")
        return self.det_net(det_normalize(letterbox(frames.float(),
                                                    self.config.det_hw)))

    def _select_faces(self, loc, conf, ldm) -> Detections:
        """Detector outputs -> Detections with max_faces slots per frame,
        on the device the outputs lie on."""
        cfg = self.config
        return select_faces_batch(
            loc, conf, self.anchors, cfg.frame_hw, cfg.det_hw,
            max_faces=cfg.det_maxFacesPerScene,
            score_threshold=cfg.det_threshold_bbox,
            iou_threshold=cfg.det_threshold_nms, nms_top_k=cfg.det_nmsTopK,
            nms_exact=cfg.det_nmsExact,
            ldm=ldm if self.use_landmarks else None)

    @torch.inference_mode()
    def _detect(self, frames: torch.Tensor) -> Detections:
        return self._select_faces(*self._detector_outputs(frames))

    def detect_frames(self, frames_bgr) -> Detections:
        """Detection only: (N, H, W, 3) BGR frames -> Detections (boxes,
        scores, valid, landmarks) in frame pixels, as device tensors."""
        return self._detect(_own_frames(frames_bgr, self.device))

    @torch.inference_mode()
    def _recognize_frames(self, frames: torch.Tensor, return_crops: bool
                          ) -> FrameResult:
        det = self._detect(frames)
        n, nf = det.valid.shape
        if self.align:
            faces = warp_align_frames(frames, det.landmarks,
                                      self.config.rec_hw, dtype=self.dtype)
        else:
            faces = crop_resize(frames.float(), det.boxes, self.config.rec_hw,
                                "cubic")
        flat = faces.reshape(n * nf, *faces.shape[2:])
        emb = self.rec_net(rec_normalize(flat)).reshape(n, nf, -1)
        return FrameResult(det.boxes, det.scores, det.valid, emb,
                           det.landmarks, faces if return_crops else None)

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

    def recognize_and_match(self, frames_bgr, gallery_arr: torch.Tensor,
                            count: int, k: int = 1,
                            return_crops: bool = False,
                            gallery_scale: Optional[torch.Tensor] = None):
        """Frames -> (FrameResult, sims (N, F, k), gallery idx (N, F, k)):
        the WS ``/inference`` batch. Pass the fields of a
        ``GalleryStore.snapshot()``; an int8 gallery needs its scales."""
        res = self._recognize_frames(_own_frames(frames_bgr, self.device),
                                     return_crops)
        vals, idx = self.match_flat(res.embeddings, gallery_arr, count, k,
                                    gallery_scale)
        return res, vals, idx

    # -- pre-cropped faces ----------------------------------------------------

    @torch.inference_mode()
    def _embed(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, rec_h, rec_w, 3) BGR on the device -> (N, D) f32."""
        return self.rec_net(rec_normalize(imgs.float()))

    @torch.inference_mode()
    def match_flat(self, flat_embeddings, gallery_arr: torch.Tensor,
                   count: int, k: int = 1,
                   gallery_scale: Optional[torch.Tensor] = None):
        """Gallery match only: (..., D) embeddings -> (sims (..., k), idx).
        An int8 gallery (with its per-row ``gallery_scale``) takes the f32
        embeddings; a float one takes them cast to its dtype."""
        flat = torch.as_tensor(flat_embeddings, device=self.device)
        lead = flat.shape[:-1]
        q = flat.reshape(-1, flat.shape[-1])
        if gallery_arr.dtype == torch.int8:
            vals, idx = cosine_topk_int8(gallery_arr, gallery_scale,
                                         q.float().contiguous(), count, k)
        else:
            vals, idx = cosine_topk(gallery_arr,
                                    q.to(gallery_arr.dtype).contiguous(),
                                    count, k)
        return vals.reshape(*lead, -1), idx.reshape(*lead, -1)

    def embed_and_match(self, imgs_bgr, gallery_arr: torch.Tensor,
                        count: int, k: int = 1,
                        gallery_scale: Optional[torch.Tensor] = None):
        """(N, rec_h, rec_w, 3) crops -> (emb (N, D), sims (N, k), idx)."""
        emb = self._embed(_own_frames(imgs_bgr, self.device))
        vals, idx = self.match_flat(emb, gallery_arr, count, k, gallery_scale)
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
