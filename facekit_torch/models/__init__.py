from facekit_torch.models.arcface import (  # noqa: F401
    ARCFACE_STAGE_UNITS,
    ArcFace,
    block_specs,
)
