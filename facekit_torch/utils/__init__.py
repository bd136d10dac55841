from facekit_torch.utils.device import resolve_device  # noqa: F401
from facekit_torch.utils.metrics import LatencyTracker  # noqa: F401
