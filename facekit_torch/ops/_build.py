"""Build the port's native sources at first use; load them with ctypes.

Each CUDA source under ``ops/csrc/`` exports a plain C function, so nvcc
compiles it in seconds without PyTorch's headers. The host library
``native/host_ops.cpp`` (JPEG codec, resize, NMS, gallery scan) is built
by g++ with facekit's flags (``build_host``). Every library lands in
``build/facekit_torch/`` inside the checkout, named by a digest of its
source (with the shared ``csrc/*.cuh`` headers for the kernels), the
flags and, for the host library, the target that ``-march=native``
resolves to, so an edited source is rebuilt, a built one reused, and a
library built on another CPU never loaded. A build writes a file of its
own and renames it into place, so processes that build at once agree.
Nothing is built at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "facekit_torch"

#: kernel name -> source file under ops/csrc
SOURCES = {"cosine_topk": "cosine_topk.cu",
           "cosine_topk_int8": "cosine_topk_int8.cu",
           "conv_s8": "conv_s8.cu",
           "ir_block": "ir_block.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: the host library: g++ with facekit's flags (facekit/native/__init__.py)
HOST_SOURCE = Path(__file__).resolve().parents[1] / "native" / "host_ops.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
GXX_LIBS = ("-ljpeg",)

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


def _digest_path(name: str, payload: bytes) -> Path:
    digest = hashlib.sha256(payload).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def library_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    for header in sorted(_CSRC.glob("*.cuh")):
        src += header.read_bytes()
    return _digest_path(name, src + " ".join(NVCC_FLAGS).encode())


def _start(cmd, out: Path):
    """Start ``cmd`` writing to a file of this process and thread next to
    ``out``; returns (process, that file, out)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(jobs) -> Tuple[Dict[str, str], list]:
    """Wait for the started builds; rename each built file into place.
    Returns (each compiler's output by name, the names that failed)."""
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            with contextlib.suppress(OSError):
                os.unlink(tmp)
        else:
            os.replace(tmp, out)        # atomic: concurrent builds agree
    return logs, failed


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
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                       else []), str(_CSRC / SOURCES[name])]
        jobs[name] = _start(cmd, out)
    logs, failed = _finish(jobs)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def host_library_path() -> Path:
    """Where the host library of this source, these flags and this CPU
    lives. ``-march=native`` is resolved by asking g++ for its target
    options, so a checkout copied to another machine builds anew there."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host ops need a C++ "
                           "compiler")
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    return _digest_path("host_ops", HOST_SOURCE.read_bytes()
                        + " ".join(GXX_FLAGS + GXX_LIBS).encode()
                        + target.encode())


def build_host() -> Path:
    """Compile ``native/host_ops.cpp`` if it is not built yet; returns the
    library's path. Raises RuntimeError with the compiler's output when
    g++ is missing or the build fails (libjpeg's header or library
    missing, for one)."""
    out = host_library_path()
    if not out.exists():
        cmd = [shutil.which("g++"), *GXX_FLAGS, str(HOST_SOURCE), *GXX_LIBS]
        logs, failed = _finish({"host_ops": _start(cmd, out)})
        if failed:
            raise RuntimeError("g++ failed for native/host_ops.cpp:\n"
                               + logs["host_ops"])
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
