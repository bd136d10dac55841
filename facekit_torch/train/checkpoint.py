"""Train-state checkpoints without JAX.

facekit checkpoints through orbax (``facekit/train/checkpoint.py``), which
needs JAX; the port has its own format. A checkpoint is a directory
holding one file, ``train_state.msgpack``, written by ``weights.io``'s
msgpack writer: the format tag, the update count and every tensor of the
state (backbone leaves, head, momentum) as an array with its dtype and
shape.

A state placed on a mesh (``train.step.place_state``) is saved whole:
its head put back together from its blocks, one copy of each replicated
leaf. Restored into a placed template, each tensor is placed as the
template's is (the head back on its blocks over ``"model"``).

A save writes into a new directory beside ``path`` and then renames:
the directory itself into place when ``path`` is new, or its file over
the old one (``os.replace``) when ``path`` is a checkpoint already. Either
rename is atomic, so a crash leaves the old checkpoint or the new one.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from facekit_torch.parallel import device_put, gather, sharding_of
from facekit_torch.train.step import TrainState
from facekit_torch.weights.io import load_params, save_params

FORMAT = "facekit-torch-train-v1"
FILE = "train_state.msgpack"
#: files orbax writes into a checkpoint directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                  "_sharding", "checkpoint")


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: gather(t).detach().cpu().numpy() for k, t in tensors.items()}


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``state`` to the directory ``path``; see the module docstring
    for how it replaces an earlier one."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not os.path.isfile(os.path.join(path, FILE)):
        raise ValueError(f"{path} exists and is not a facekit_torch "
                         "checkpoint; refusing to write over it")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tree = {"format": FORMAT, "step": np.int64(state.step),
            "params": _numpy(state.params), "head": _numpy(state.head),
            "momentum": {k: _numpy(v) for k, v in state.momentum.items()}}
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        save_params(tree, os.path.join(tmp, FILE))
        with open(os.path.join(tmp, FILE), "rb") as f:
            os.fsync(f.fileno())
        if os.path.exists(path):
            os.replace(os.path.join(tmp, FILE), os.path.join(path, FILE))
        else:
            os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _refuse_others(path: str) -> None:
    """Raise unless ``path`` is missing (the read then raises) or holds a
    checkpoint of this module's."""
    if os.path.isfile(path):
        raise ValueError(f"{path} is a file; a facekit_torch checkpoint is "
                         f"a directory holding {FILE}")
    if os.path.isdir(path) and not os.path.isfile(os.path.join(path, FILE)):
        found = [m for m in _ORBAX_MARKERS
                 if os.path.exists(os.path.join(path, m))]
        what = (f"an orbax checkpoint (it holds {', '.join(found)}), "
                "facekit's format" if found else "not a facekit_torch "
                "checkpoint")
        raise ValueError(f"{path} is {what}: facekit_torch reads only its "
                         f"own checkpoints ({FILE}); reading orbax's needs "
                         "orbax and JAX, which the port does not use")


def _tensors(saved: Dict, template: Dict[str, torch.Tensor],
             what: str) -> Dict[str, torch.Tensor]:
    """``saved``'s arrays as tensors on the template's devices, placed as
    its tensors are; refuses other keys, shapes or dtypes."""
    if set(saved) != set(template):
        missing = sorted(set(template) - set(saved))[:5]
        extra = sorted(set(saved) - set(template))[:5]
        raise ValueError(f"checkpoint {what} do not fit the template: "
                         f"missing {missing}, unexpected {extra}")
    out = {}
    for key, ref in template.items():
        arr = np.asarray(saved[key])
        t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"checkpoint {what} {key}: {t.dtype} "
                             f"{tuple(t.shape)} does not fit the template's "
                             f"{ref.dtype} {tuple(ref.shape)}")
        sharding = sharding_of(ref)
        out[key] = (t.to(ref.device) if sharding is None
                    else device_put(t, sharding))
    return out


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """The state saved at ``path``, on the devices of ``template``, whose
    keys, shapes and dtypes it must match. Refuses an orbax directory."""
    path = os.path.abspath(path)
    _refuse_others(path)
    tree = load_params(os.path.join(path, FILE))
    if tree.get("format") != FORMAT:
        raise ValueError(f"{path}: format {tree.get('format')!r}, "
                         f"{FORMAT!r} expected")
    momentum = {k: _tensors(tree["momentum"].get(k, {}), v, f"momentum.{k}")
                for k, v in template.momentum.items()}
    return TrainState(_tensors(tree["params"], template.params, "params"),
                      _tensors(tree["head"], template.head, "head"),
                      momentum, int(tree["step"]))


def latest_step_dir(root: str) -> Optional[str]:
    """The highest-numbered ``step_N`` directory under ``root``, or None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and d[5:].isdigit():
            steps.append(int(d[5:]))
    if not steps:
        return None
    return os.path.join(root, f"step_{max(steps)}")
