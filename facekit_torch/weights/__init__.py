from facekit_torch.weights.bridge import (  # noqa: F401
    from_jax,
    load_params,
    random_arcface_params,
    random_retinaface_params,
)
