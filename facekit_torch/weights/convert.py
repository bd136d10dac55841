"""Reference PyTorch state_dicts -> param trees in facekit's layout.

The port's own, numpy-only copy of ``facekit/weights/convert.py``: the
key maps of the reference model definitions (ArcFace IR / IR-SE,
``conversion/arcface/model_irse.py``; RetinaFace-MobileNet0.25,
``conversion/retina/models/retinaface.py`` and ``net.py``; the slim and
RFB light detectors, ``net_slim.py`` and ``net_rfb.py``) into the nested
trees ``facekit.models`` consumes: HWIO convs and facekit's keys, numpy
leaves. ``from_jax`` takes such a tree unchanged, and ``save_params``
writes it as a file that either package loads. float64 tensors become
float32, as facekit's ``jnp.asarray`` makes them.

A conversion refuses silent partial loads (the reference's
``check_keys``, ``conversion/retina/torch2trt.py:28-64``): a missing key is
named with its neighbours, and keys the mapping never consumed refuse the
checkpoint unless ``strict=False``. ``module.`` (DataParallel) prefixes
are stripped and ``num_batches_tracked`` is ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from facekit_torch.models.arcface import block_specs
from facekit_torch.models.lightdet import DW_CHAIN, RFB_INDEX
from facekit_torch.models.retinaface import _STAGE1, _STAGE2, _STAGE3


class ConversionError(KeyError):
    """Checkpoint does not match the requested model mapping."""

    def __str__(self):  # KeyError quotes its arg; keep the message readable
        return self.args[0] if self.args else ""


def _strip_module(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


class _TrackedState:
    """Checkpoint wrapper: strips ``module.`` prefixes, records which keys
    the conversion consumed, and turns a missing key into a diagnostic
    instead of a bare KeyError."""

    #: torch bookkeeping never used by inference params
    _IGNORED_SUFFIXES = (".num_batches_tracked",)

    def __init__(self, sd: Mapping[str, Any]):
        self.data: Dict[str, Any] = {_strip_module(k): v
                                     for k, v in sd.items()}
        self.consumed: set = set()

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def __getitem__(self, key: str):
        if key not in self.data:
            near = sorted(k for k in self.data
                          if k.split(".")[0] == key.split(".")[0])[:8]
            hint = ("; checkpoint keys under the same module: "
                    + ", ".join(near)) if near else ""
            raise ConversionError(
                f"checkpoint is missing key `{key}` required by this model "
                f"mapping ({len(self.data)} keys present{hint}). Wrong "
                "--network variant, or a differently-structured checkpoint?")
        self.consumed.add(key)
        return self.data[key]

    def check_consumed(self, model: str) -> None:
        """Fail if the checkpoint held tensors the mapping never consumed
        (extra heads, optimizer state, training wrappers...)."""
        left = [k for k in self.data
                if k not in self.consumed
                and not k.endswith(self._IGNORED_SUFFIXES)]
        if left:
            shown = ", ".join(sorted(left)[:12])
            more = f" (+{len(left) - 12} more)" if len(left) > 12 else ""
            raise ConversionError(
                f"{len(left)} checkpoint keys were never consumed by the "
                f"{model} mapping: {shown}{more}. Refusing a silent partial "
                "load — strip training-only state or pick the matching "
                "network variant (pass strict=False to convert anyway).")


def _tracked(sd: Mapping[str, Any]) -> _TrackedState:
    return sd if isinstance(sd, _TrackedState) else _TrackedState(sd)


def _np(x) -> np.ndarray:
    """A leaf as a numpy array of its own (float64 -> float32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32 if x.dtype == np.float64 else x.dtype,
                    order="C", copy=True)


def _conv(sd, key: str) -> np.ndarray:
    """OIHW torch conv weight -> HWIO."""
    return np.ascontiguousarray(_np(sd[key]).transpose(2, 3, 1, 0))


def _bn(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": _np(sd[prefix + ".weight"]),
        "bias": _np(sd[prefix + ".bias"]),
        "mean": _np(sd[prefix + ".running_mean"]),
        "var": _np(sd[prefix + ".running_var"]),
    }


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth/.tar checkpoint -> {key: numpy array}, on the CPU, with a
    ``state_dict`` entry unwrapped and ``module.`` prefixes stripped.

    ``weights_only=False``, as facekit loads them, so the same files load:
    it unpickles, so load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[_strip_module(k)] = np.asarray(v)
    return out


# -- ArcFace IR / IR-SE --------------------------------------------------------

def convert_arcface_state_dict(sd: Mapping[str, Any],
                               network: str = "ir_50",
                               strict: bool = True) -> Dict[str, Any]:
    """An IR / IR-SE state_dict (``ir_50``, ``ir_101``, ``ir_152``, their
    ``ir_se_*`` forms, ``ir_tiny``) -> facekit's ArcFace tree."""
    sd = _tracked(sd)
    params: Dict[str, Any] = {
        "input": {
            "conv": _conv(sd, "input_layer.0.weight"),
            "bn": _bn(sd, "input_layer.1"),
            "prelu": _np(sd["input_layer.2.weight"]),
        },
        "blocks": [],
        "output": {
            "bn2d": _bn(sd, "output_layer.0"),
            "linear": {
                "w": _np(sd["output_layer.3.weight"]),
                "b": _np(sd["output_layer.3.bias"]),
            },
            "bn1d": _bn(sd, "output_layer.4"),
        },
    }
    for i, (in_c, depth, _) in enumerate(block_specs(network)):
        pre = f"body.{i}"
        blk: Dict[str, Any] = {
            "bn1": _bn(sd, f"{pre}.res_layer.0"),
            "conv1": _conv(sd, f"{pre}.res_layer.1.weight"),
            "prelu": _np(sd[f"{pre}.res_layer.2.weight"]),
            "conv2": _conv(sd, f"{pre}.res_layer.3.weight"),
            "bn2": _bn(sd, f"{pre}.res_layer.4"),
        }
        if in_c != depth:
            blk["shortcut"] = {
                "conv": _conv(sd, f"{pre}.shortcut_layer.0.weight"),
                "bn": _bn(sd, f"{pre}.shortcut_layer.1"),
            }
        if f"{pre}.res_layer.5.fc1.weight" in sd:  # IR-SE variant
            blk["se"] = {
                "fc1": _conv(sd, f"{pre}.res_layer.5.fc1.weight"),
                "fc2": _conv(sd, f"{pre}.res_layer.5.fc2.weight"),
            }
        params["blocks"].append(blk)
    if strict:
        sd.check_consumed(f"arcface {network}")
    return params


# -- RetinaFace MobileNetV1x0.25 -----------------------------------------------

def _conv_bn_unit(sd, prefix) -> Dict[str, Any]:
    return {"conv": _conv(sd, prefix + ".0.weight"), "bn": _bn(sd, prefix + ".1")}


def _conv_dw_unit(sd, prefix) -> Dict[str, Any]:
    return {
        "dw_conv": _conv(sd, prefix + ".0.weight"),
        "dw_bn": _bn(sd, prefix + ".1"),
        "pw_conv": _conv(sd, prefix + ".3.weight"),
        "pw_bn": _bn(sd, prefix + ".4"),
    }


def _head_unit(sd, prefix) -> Dict[str, Any]:
    return {"w": _conv(sd, prefix + ".conv1x1.weight"),
            "b": _np(sd[prefix + ".conv1x1.bias"])}


def convert_retinaface_state_dict(sd: Mapping[str, Any],
                                  strict: bool = True) -> Dict[str, Any]:
    """A RetinaFace-MobileNet0.25 state_dict -> facekit's tree, with the
    landmark head when the checkpoint has ``LandmarkHead``."""
    sd = _tracked(sd)
    params: Dict[str, Any] = {
        "stem": _conv_bn_unit(sd, "body.stage1.0"),
        "stage1": [_conv_dw_unit(sd, f"body.stage1.{i + 1}")
                   for i in range(len(_STAGE1))],
        "stage2": [_conv_dw_unit(sd, f"body.stage2.{i}")
                   for i in range(len(_STAGE2))],
        "stage3": [_conv_dw_unit(sd, f"body.stage3.{i}")
                   for i in range(len(_STAGE3))],
        "fpn": {name: _conv_bn_unit(sd, f"fpn.{name}")
                for name in ("output1", "output2", "output3", "merge1",
                             "merge2")},
        "class_head": [_head_unit(sd, f"ClassHead.{i}") for i in range(3)],
        "bbox_head": [_head_unit(sd, f"BboxHead.{i}") for i in range(3)],
    }
    for n in (1, 2, 3):
        # note the reference's mixed-case attribute: conv7x7_3 (net.py:53)
        params[f"ssh{n}"] = {
            "conv3x3": _conv_bn_unit(sd, f"ssh{n}.conv3X3"),
            "conv5x5_1": _conv_bn_unit(sd, f"ssh{n}.conv5X5_1"),
            "conv5x5_2": _conv_bn_unit(sd, f"ssh{n}.conv5X5_2"),
            "conv7x7_2": _conv_bn_unit(sd, f"ssh{n}.conv7X7_2"),
            "conv7x7_3": _conv_bn_unit(sd, f"ssh{n}.conv7x7_3"),
        }
    if "LandmarkHead.0.conv1x1.weight" in sd:
        params["ldm_head"] = [_head_unit(sd, f"LandmarkHead.{i}")
                              for i in range(3)]
    if strict:
        sd.check_consumed("retinaface")
    return params


# -- Slim / RFB light detectors (net_slim.py, net_rfb.py) ----------------------

def _biased_conv(sd, prefix) -> Dict[str, Any]:
    return {"w": _conv(sd, prefix + ".weight"),
            "b": _np(sd[prefix + ".bias"])}


def _depth_conv2d_unit(sd, prefix) -> Dict[str, Any]:
    """depth_conv2d Sequential: .0 biased dw conv, .1 ReLU, .2 biased 1x1."""
    return {
        "dw_w": _conv(sd, prefix + ".0.weight"),
        "dw_b": _np(sd[prefix + ".0.bias"]),
        "pw_w": _conv(sd, prefix + ".2.weight"),
        "pw_b": _np(sd[prefix + ".2.bias"]),
    }


def _basic_conv_unit(sd, prefix) -> Dict[str, Any]:
    p = {"w": _conv(sd, prefix + ".conv.weight")}
    if prefix + ".bn.weight" in sd:
        p["bn"] = _bn(sd, prefix + ".bn")
    else:
        p["b"] = _np(sd[prefix + ".conv.bias"])
    return p


def convert_lightdet_state_dict(sd: Mapping[str, Any],
                                variant: str = "slim",
                                strict: bool = True) -> Dict[str, Any]:
    """A slim or RFB state_dict -> facekit's light-detector tree, with
    ``None`` at RFB's ``dw[6]`` and its ``BasicRFB`` block as ``rfb8``."""
    sd = _tracked(sd)
    params: Dict[str, Any] = {
        "conv1": _conv_bn_unit(sd, "conv1"),
        "dw": [],
        "conv14_a": _biased_conv(sd, "conv14.0"),
        "conv14_b": _depth_conv2d_unit(sd, "conv14.2"),
    }
    for i in range(len(DW_CHAIN)):            # conv2..conv13
        if variant == "rfb" and i == RFB_INDEX:
            params["dw"].append(None)
            params["rfb8"] = {
                "b0": [_basic_conv_unit(sd, f"conv8.branch0.{j}")
                       for j in range(3)],
                "b1": [_basic_conv_unit(sd, f"conv8.branch1.{j}")
                       for j in range(3)],
                "b2": [_basic_conv_unit(sd, f"conv8.branch2.{j}")
                       for j in range(4)],
                "linear": _basic_conv_unit(sd, "conv8.ConvLinear"),
                "shortcut": _basic_conv_unit(sd, "conv8.shortcut"),
            }
        else:
            params["dw"].append(_conv_dw_unit(sd, f"conv{i + 2}"))
    for name in ("loc", "conf", "landm"):
        params[name] = [_depth_conv2d_unit(sd, f"{name}.{lvl}") if lvl < 3
                        else _biased_conv(sd, f"{name}.{lvl}")
                        for lvl in range(4)]
    if strict:
        sd.check_consumed(f"lightdet {variant}")
    return params
