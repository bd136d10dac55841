from facekit_torch.weights.bridge import (  # noqa: F401
    from_jax,
    random_arcface_params,
    random_lightdet_params,
    random_retinaface_params,
    to_jax,
)
from facekit_torch.weights.convert import (  # noqa: F401
    ConversionError,
    convert_arcface_state_dict,
    convert_lightdet_state_dict,
    convert_retinaface_state_dict,
    load_torch_checkpoint,
)
from facekit_torch.weights.io import load_params, save_params  # noqa: F401
