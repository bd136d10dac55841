"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each source under ``ops/csrc/`` exports a plain C function, so it compiles
in seconds without PyTorch's headers. The library lands in
``build/facekit_torch/`` inside the checkout, named by a digest of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a built one reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "facekit_torch"

#: kernel name -> source file under ops/csrc
SOURCES = {"cosine_topk": "cosine_topk.cu",
           "cosine_topk_int8": "cosine_topk_int8.cu",
           "conv_s8": "conv_s8.cu",
           "ir_block": "ir_block.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def library_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    for header in sorted(_CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet.

    One nvcc per source, all started together. Returns each compiler's
    output by name (with ``ptxas_verbose``, the registers, shared memory
    and spills of every kernel); raises if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                       else []),
               "-o", str(tmp), str(_CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)        # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
