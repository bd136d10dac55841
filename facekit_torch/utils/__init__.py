from facekit_torch.utils.device import resolve_device  # noqa: F401
from facekit_torch.utils.metrics import LatencyTracker, StageTimer  # noqa: F401
from facekit_torch.utils.profiling import profile_trace  # noqa: F401
