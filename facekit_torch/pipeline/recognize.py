"""The embed + match pipeline: the ``/recognize`` and enrollment path.

Port of ``FacePipeline``'s embed and match methods
(``facekit/pipeline/recognize.py:304-354``, ``:491-534``): pre-cropped BGR
faces -> ``rec_normalize`` -> ArcFace -> gallery search. PyTorch runs
eagerly, so each method is the body of facekit's jitted program. The
detect methods come with the detect slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from facekit_torch.config import FaceKitConfig
from facekit_torch.models.arcface import ArcFace
from facekit_torch.ops.preprocess import rec_normalize
from facekit_torch.ops.resize import resize_image
from facekit_torch.ops.similarity import cosine_topk
from facekit_torch.utils.device import resolve_device
from facekit_torch.weights.bridge import from_jax

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
        self.rec_net = net.set_compute_dtype(self.dtype).to(self.device).eval()

    @torch.inference_mode()
    def _embed(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, rec_h, rec_w, 3) BGR on the device -> (N, D) f32."""
        return self.rec_net(rec_normalize(imgs.float()))

    @torch.inference_mode()
    def match_flat(self, flat_embeddings, gallery_arr: torch.Tensor,
                   count: int, k: int = 1):
        """Gallery match only: (..., D) embeddings -> (sims (..., k), idx)."""
        flat = torch.as_tensor(flat_embeddings, device=self.device)
        lead = flat.shape[:-1]
        q = flat.reshape(-1, flat.shape[-1]).to(gallery_arr.dtype).contiguous()
        vals, idx = cosine_topk(gallery_arr, q, count, k)
        return vals.reshape(*lead, -1), idx.reshape(*lead, -1)

    def embed_and_match(self, imgs_bgr, gallery_arr: torch.Tensor,
                        count: int, k: int = 1):
        """(N, rec_h, rec_w, 3) crops -> (emb (N, D), sims (N, k), idx)."""
        emb = self._embed(_own_frames(imgs_bgr, self.device))
        vals, idx = self.match_flat(emb, gallery_arr, count, k)
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
