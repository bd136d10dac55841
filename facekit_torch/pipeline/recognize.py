"""The embed + match pipeline: the ``/recognize`` and enrollment path.

Port of ``FacePipeline``'s embed and match methods
(``facekit/pipeline/recognize.py:304-354``, ``:491-534``): pre-cropped BGR
faces -> ``rec_normalize`` -> ArcFace -> gallery search. PyTorch runs
eagerly, so each method is the body of facekit's jitted program. The
detect methods come with the detect slice.

With ``rec_quantize`` the embedder is the int8 ArcFace, dynamic until
``calibrate_embedder`` fixes its activation scales; the float weights stay
on the host for that (``facekit/pipeline/recognize.py:373-416``). An int8
gallery is searched with the f32 embeddings (``_match_queries``,
``:208-225``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from facekit_torch.config import FaceKitConfig
from facekit_torch.models.arcface import (ArcFace, calibrate_arcface_int8,
                                          quantize_arcface)
from facekit_torch.ops.preprocess import rec_normalize
from facekit_torch.ops.resize import resize_image
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


class FacePipeline:
    """Owns the embedder for one config, on one device."""

    def __init__(self, config: FaceKitConfig, rec_params: Dict[str, Any],
                 device=None):
        """``rec_params``: the embedder's params in facekit's layout (what
        ``facekit.models.arcface_init``, ``weights.load_params`` or
        ``weights.random_arcface_params`` return), carried over by
        ``weights.bridge.from_jax``. ``device`` defaults to ``"cuda"``."""
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
