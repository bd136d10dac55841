"""Device mesh: named axes over the local devices of one process.

Port of ``facekit/parallel/mesh.py``. facekit's server is one process
that drives every local chip through one ``jax.sharding.Mesh``; the
port's is one process that owns every local GPU. A ``Mesh`` here is
only bookkeeping: ordered axis names, their sizes, and an array of
``torch.device`` in that shape. Work is placed on a position's device
by the callers (``parallel.sharded_search``, the pipeline); nothing
launches collectives.

A device may stand at several positions (an explicit device list that
repeats one): the CPU tests build an 8-position mesh on torch's single
CPU device that way, and one GPU can hold a whole mesh. Code that keeps
one replica per device (gallery blocks, networks) keys it by
``canonical(device)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def canonical(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``"cuda"`` is the
    current CUDA device, so ``cuda`` and ``cuda:0`` key one replica."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> List[torch.device]:
    """Every local GPU, ``cuda:0`` ... ``cuda:{n-1}``. Raises without one:
    a mesh never falls back to the CPU on its own (the CPU tests pass their
    devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: torch.cuda.is_available() is False; pass devices= "
            "(e.g. ['cpu'] * n) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Named axes (ordered) over an array of devices of that shape."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh: {devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The device at position 0: where results are gathered."""
        return self.devices.flat[0]

    def device_at(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates, 0 on the others."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh has no axes {sorted(unknown)} (axes "
                             f"{self.axis_names})")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def devices_along(self, axis: str, coord: int) -> List[torch.device]:
        """The distinct devices at coordinate ``coord`` of ``axis``, over
        every position of the other axes (the replicas of a block)."""
        sub = np.take(self.devices, [coord], axis=self.axis_names.index(axis))
        return list(dict.fromkeys(canonical(d) for d in sub.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh (``facekit/parallel/mesh.py:18-30``); default: every
    local GPU on a single ``"gallery"`` axis. ``devices`` (any torch device
    spellings, repeats allowed) fills the mesh in order; a mesh that needs
    more devices than there are is refused."""
    devices = local_devices() if devices is None else [
        canonical(d) for d in devices]
    if axes is None:
        axes = {"gallery": len(devices)}
    shape = tuple(int(v) for v in axes.values())
    if any(v < 1 for v in shape):
        raise ValueError(f"mesh axes {dict(axes)}: every size must be >= 1")
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), tuple(axes.keys()))
