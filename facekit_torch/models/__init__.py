from facekit_torch.models.arcface import (  # noqa: F401
    ARCFACE_STAGE_UNITS,
    ArcFace,
    arcface_act_amax,
    block_specs,
    calibrate_arcface_int8,
    quantize_arcface,
)
from facekit_torch.models.retinaface import RetinaFace  # noqa: F401
