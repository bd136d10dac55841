"""The detector family of a ``det_network``, as facekit's
``init_model_params`` dispatches on it (``facekit/models/__init__.py:
25-31``): RetinaFace-MobileNet0.25, or a light detector (slim, RFB) with
its own anchors and its landmark heads always present (``landm``)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from torch import nn

from facekit_torch.models.lightdet import VARIANTS, LightDet
from facekit_torch.models.retinaface import RetinaFace
from facekit_torch.ops.anchors import (RETINAFACE_MIN_SIZES, RETINAFACE_STEPS,
                                       SLIM_RFB_MIN_SIZES, SLIM_RFB_STEPS)


class DetectorFamily(NamedTuple):
    build: Callable[[dict], nn.Module]     # the f32 module for a param tree
    steps: Tuple[int, ...]                 # anchor steps
    min_sizes: Tuple[Tuple[int, ...], ...]  # anchor sizes per step
    landmarks: str                         # key of its landmark heads
    random_params: Callable[[int, bool], dict]  # (seed, with_landmarks)


def detector_family(det_network: str) -> DetectorFamily:
    """The module, anchors, landmark key and random init of
    ``det_network``'s detector (a light detector for ``slim`` / ``rfb``,
    RetinaFace for any other name)."""
    from facekit_torch.weights.bridge import (random_lightdet_params,
                                              random_retinaface_params)
    if det_network in VARIANTS:
        return DetectorFamily(
            lambda params: LightDet(det_network), SLIM_RFB_STEPS,
            SLIM_RFB_MIN_SIZES, "landm",
            lambda seed, with_landmarks: random_lightdet_params(
                det_network, seed=seed))
    return DetectorFamily(
        lambda params: RetinaFace(with_landmarks="ldm_head" in params),
        RETINAFACE_STEPS, RETINAFACE_MIN_SIZES, "ldm_head",
        lambda seed, with_landmarks: random_retinaface_params(
            seed=seed, with_landmarks=with_landmarks))
