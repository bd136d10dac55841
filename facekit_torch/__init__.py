"""facekit_torch — facekit ported to PyTorch and CUDA for one NVIDIA H100.

A second package beside ``facekit`` (the JAX reference), with the same
module layout and names. It serves the server's ``/recognize`` and
enrollment path of ``configs/default.json`` (the IR ArcFace embedder and
the bf16/f32 gallery search) and of ``configs/throughput.json`` (the int8
embedder and the int8 gallery). Its kernels are hand-written CUDA for
Hopper: ``ops/csrc/cosine_topk.cu``, ``cosine_topk_int8.cu`` and
``conv_s8.cu``. Imports ``torch`` and nothing of JAX or ``facekit``.
"""

__version__ = "0.1.0"

from facekit_torch.config import FaceKitConfig, load_config  # noqa: F401
from facekit_torch.utils.device import resolve_device  # noqa: F401
from facekit_torch.utils.metrics import LatencyTracker  # noqa: F401
