"""The inverse of the checkpoint converters: a param tree in facekit's
layout -> a state_dict in the reference's layout (OIHW conv weights,
BatchNorm ``weight`` / ``bias`` / ``running_mean`` / ``running_var`` and
``num_batches_tracked``, the reference's module names).

Test and smoke code only: it lets the CPU tests and ``chip_smoke.py``
write reference-layout checkpoints from numpy-drawn trees
(``facekit_torch.weights.random_*_params``) with no checkpoint file and no
reference checkout. Imports numpy and torch only.
"""

from typing import Any, Dict

import numpy as np
import torch


def _conv(out, key, hwio) -> None:
    out[key] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(hwio).transpose(3, 2, 0, 1)))


def _t(out, key, arr) -> None:
    out[key] = torch.from_numpy(np.array(arr, copy=True))


def _bn(out, prefix, p) -> None:
    for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
        _t(out, f"{prefix}.{theirs}", p[ours])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(7)


def arcface_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """ArcFace IR / IR-SE tree -> ``model_irse.py``'s state_dict keys."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "input_layer.0.weight", tree["input"]["conv"])
    _bn(sd, "input_layer.1", tree["input"]["bn"])
    _t(sd, "input_layer.2.weight", tree["input"]["prelu"])
    for i, blk in enumerate(tree["blocks"]):
        pre = f"body.{i}"
        _bn(sd, f"{pre}.res_layer.0", blk["bn1"])
        _conv(sd, f"{pre}.res_layer.1.weight", blk["conv1"])
        _t(sd, f"{pre}.res_layer.2.weight", blk["prelu"])
        _conv(sd, f"{pre}.res_layer.3.weight", blk["conv2"])
        _bn(sd, f"{pre}.res_layer.4", blk["bn2"])
        if "shortcut" in blk:
            _conv(sd, f"{pre}.shortcut_layer.0.weight", blk["shortcut"]["conv"])
            _bn(sd, f"{pre}.shortcut_layer.1", blk["shortcut"]["bn"])
        if "se" in blk:
            _conv(sd, f"{pre}.res_layer.5.fc1.weight", blk["se"]["fc1"])
            _conv(sd, f"{pre}.res_layer.5.fc2.weight", blk["se"]["fc2"])
    out = tree["output"]
    _bn(sd, "output_layer.0", out["bn2d"])
    _t(sd, "output_layer.3.weight", out["linear"]["w"])
    _t(sd, "output_layer.3.bias", out["linear"]["b"])
    _bn(sd, "output_layer.4", out["bn1d"])
    return sd


def _conv_bn(sd, prefix, p) -> None:
    _conv(sd, f"{prefix}.0.weight", p["conv"])
    _bn(sd, f"{prefix}.1", p["bn"])


def _conv_dw(sd, prefix, p) -> None:
    _conv(sd, f"{prefix}.0.weight", p["dw_conv"])
    _bn(sd, f"{prefix}.1", p["dw_bn"])
    _conv(sd, f"{prefix}.3.weight", p["pw_conv"])
    _bn(sd, f"{prefix}.4", p["pw_bn"])


def retinaface_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """RetinaFace-MobileNet0.25 tree -> ``retinaface.py`` / ``net.py``'s
    state_dict keys (``LandmarkHead`` when the tree has ``ldm_head``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_bn(sd, "body.stage1.0", tree["stem"])
    for i, p in enumerate(tree["stage1"]):
        _conv_dw(sd, f"body.stage1.{i + 1}", p)
    for stage in ("stage2", "stage3"):
        for i, p in enumerate(tree[stage]):
            _conv_dw(sd, f"body.{stage}.{i}", p)
    for name, p in tree["fpn"].items():
        _conv_bn(sd, f"fpn.{name}", p)
    names = {"conv3x3": "conv3X3", "conv5x5_1": "conv5X5_1",
             "conv5x5_2": "conv5X5_2", "conv7x7_2": "conv7X7_2",
             "conv7x7_3": "conv7x7_3"}
    for n in (1, 2, 3):
        for ours, theirs in names.items():
            _conv_bn(sd, f"ssh{n}.{theirs}", tree[f"ssh{n}"][ours])
    heads = {"class_head": "ClassHead", "bbox_head": "BboxHead",
             "ldm_head": "LandmarkHead"}
    for ours, theirs in heads.items():
        for i, p in enumerate(tree.get(ours, [])):
            _conv(sd, f"{theirs}.{i}.conv1x1.weight", p["w"])
            _t(sd, f"{theirs}.{i}.conv1x1.bias", p["b"])
    return sd


def _biased(sd, prefix, w, b) -> None:
    _conv(sd, f"{prefix}.weight", w)
    _t(sd, f"{prefix}.bias", b)


def _depth_conv2d(sd, prefix, p) -> None:
    _biased(sd, f"{prefix}.0", p["dw_w"], p["dw_b"])
    _biased(sd, f"{prefix}.2", p["pw_w"], p["pw_b"])


def _basic_conv(sd, prefix, p) -> None:
    _conv(sd, f"{prefix}.conv.weight", p["w"])
    if "bn" in p:
        _bn(sd, f"{prefix}.bn", p["bn"])
    else:
        _t(sd, f"{prefix}.conv.bias", p["b"])


def lightdet_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Slim / RFB tree -> ``net_slim.py`` / ``net_rfb.py``'s state_dict
    keys (``conv8.branch*``, ``ConvLinear`` and ``shortcut`` where the tree
    has ``rfb8``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_bn(sd, "conv1", tree["conv1"])
    for i, p in enumerate(tree["dw"]):
        if p is not None:
            _conv_dw(sd, f"conv{i + 2}", p)
    if "rfb8" in tree:
        rfb = tree["rfb8"]
        for b in ("b0", "b1", "b2"):
            for j, p in enumerate(rfb[b]):
                _basic_conv(sd, f"conv8.branch{b[1]}.{j}", p)
        _basic_conv(sd, "conv8.ConvLinear", rfb["linear"])
        _basic_conv(sd, "conv8.shortcut", rfb["shortcut"])
    _biased(sd, "conv14.0", tree["conv14_a"]["w"], tree["conv14_a"]["b"])
    _depth_conv2d(sd, "conv14.2", tree["conv14_b"])
    for name in ("loc", "conf", "landm"):
        for lvl, p in enumerate(tree[name]):
            if lvl < 3:
                _depth_conv2d(sd, f"{name}.{lvl}", p)
            else:
                _biased(sd, f"{name}.{lvl}", p["w"], p["b"])
    return sd
