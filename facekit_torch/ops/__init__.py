from facekit_torch.ops.preprocess import det_normalize, rec_normalize  # noqa: F401
from facekit_torch.ops.resize import (  # noqa: F401
    resize_image,
    resize_matrix,
    saturate_uint8,
)
from facekit_torch.ops.similarity import (  # noqa: F401
    cosine_topk,
    cosine_topk_int8,
    cosine_topk_int8_reference,
    cosine_topk_reference,
    quantize_rows_int8,
)
from facekit_torch.ops.conv_s8 import conv_s8, conv_s8_reference  # noqa: F401
