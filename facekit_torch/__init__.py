"""facekit_torch — facekit ported to PyTorch and CUDA for one NVIDIA H100.

A second package beside ``facekit`` (the JAX reference), with the same
module layout and names. This slice serves the server's ``/recognize`` and
enrollment path: the IR ArcFace embedder and the gallery search, whose
kernel is hand-written CUDA for Hopper (``ops/csrc/cosine_topk.cu``).
Imports ``torch`` and nothing of JAX or ``facekit``.
"""

__version__ = "0.1.0"

from facekit_torch.config import FaceKitConfig, load_config  # noqa: F401
from facekit_torch.utils.device import resolve_device  # noqa: F401
from facekit_torch.utils.metrics import LatencyTracker  # noqa: F401
