from facekit_torch.ops.preprocess import det_normalize, rec_normalize  # noqa: F401
from facekit_torch.ops.resize import (  # noqa: F401
    crop_resize,
    letterbox,
    letterbox_geometry,
    resize_image,
    resize_matrix,
    saturate_uint8,
)
from facekit_torch.ops.anchors import generate_anchors  # noqa: F401
from facekit_torch.ops.boxes import (  # noqa: F401
    decode_boxes,
    decode_landmarks,
    iou_matrix,
    nms,
    select_faces,
    unletterbox_boxes,
)
from facekit_torch.ops.align import (  # noqa: F401
    umeyama,
    warp_align,
    warp_align_gather,
    warp_align_shear,
)
from facekit_torch.ops.similarity import (  # noqa: F401
    cosine_topk,
    cosine_topk_int8,
    cosine_topk_int8_reference,
    cosine_topk_reference,
    quantize_rows_int8,
)
from facekit_torch.ops.conv_s8 import conv_s8, conv_s8_reference  # noqa: F401
