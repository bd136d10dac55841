from facekit_torch.ops.preprocess import det_normalize, rec_normalize  # noqa: F401
from facekit_torch.ops.resize import (  # noqa: F401
    resize_image,
    resize_matrix,
    saturate_uint8,
)
from facekit_torch.ops.similarity import (  # noqa: F401
    cosine_topk,
    cosine_topk_reference,
)
