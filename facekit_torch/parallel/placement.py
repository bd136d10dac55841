"""Tensors placed on a mesh: replicated, or split by rows over an axis.

What ``jax.device_put`` with a ``NamedSharding`` does for facekit's train
step (``facekit/train/step.py:75-92``), in the port's one process: a
``Sharding`` names a mesh and a spec, ``()`` for a replicated tensor or
``(axis, None, ...)`` for one whose leading dim splits over ``axis``
(``PartitionSpec(axis, None, ...)``). ``device_put`` makes a
``Replicated`` (one copy on each distinct device of the mesh) or a
``ShardedRows`` (``parallel.sharded_search``: block s on every device at
coordinate s of the axis) and refuses a leading dim the axis does not
divide, as ``jax.device_put`` does; ``gather`` puts the whole tensor
back together on the mesh's home device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from facekit_torch.parallel.mesh import Mesh, canonical
from facekit_torch.parallel.sharded_search import ShardedRows, shard_gallery


class Sharding(NamedTuple):
    """Where a tensor goes: ``spec`` () replicated, or the name of the
    mesh axis its leading dim splits over followed by Nones."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


class Replicated:
    """One tensor's copies, one on each distinct device of ``mesh``."""

    def __init__(self, mesh: Mesh, copies: Dict[torch.device, torch.Tensor]):
        self.mesh = mesh
        self.copies = copies
        first = next(iter(copies.values()))
        self.shape = first.shape
        self.dtype = first.dtype

    def on(self, device) -> torch.Tensor:
        """The copy on ``device``."""
        return self.copies[canonical(device)]


def mesh_devices(mesh: Mesh):
    """The distinct devices of ``mesh``, in position order."""
    return list(dict.fromkeys(canonical(d) for d in mesh.devices.flat))


def device_put(x: torch.Tensor, sharding: Sharding):
    """``x`` placed as ``sharding`` says: a ``Replicated`` or, split over
    an axis, a ``ShardedRows`` (every copy a new tensor)."""
    axes = [a for a in sharding.spec if a is not None]
    if not axes:
        return Replicated(sharding.mesh, {
            dev: x.to(dev, copy=True) for dev in mesh_devices(sharding.mesh)})
    if sharding.spec[0] is None or len(axes) > 1:
        raise ValueError(f"sharding spec {sharding.spec}: only the leading "
                         "dim may split, over one axis")
    return shard_gallery(x, sharding.mesh, sharding.spec[0])


def sharding_of(x) -> Optional[Sharding]:
    """The ``Sharding`` ``x`` was placed with; None for a plain tensor."""
    if isinstance(x, Replicated):
        return Sharding(x.mesh, ())
    if isinstance(x, ShardedRows):
        return Sharding(x.mesh, (x.axis,) + (None,) * (len(x.shape) - 1))
    return None


def gather(x) -> torch.Tensor:
    """The whole tensor on the mesh's home device (a plain tensor as it
    is)."""
    if isinstance(x, Replicated):
        home = canonical(x.mesh.home)
        return x.copies.get(home, next(iter(x.copies.values()))).to(home)
    if isinstance(x, ShardedRows):
        home = canonical(x.mesh.home)
        return torch.cat([next(iter(b.values())).to(home) for b in x.blocks])
    return x
