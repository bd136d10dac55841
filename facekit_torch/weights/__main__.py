"""CLI: convert reference PyTorch checkpoints to param files.

The port's copy of ``facekit/weights/__main__.py``; it needs no JAX:

    python -m facekit_torch.weights arcface backbone_ir50_asia.pth arcface.msgpack
    python -m facekit_torch.weights retinaface mobilenet0.25_Final.pth retina.msgpack
    python -m facekit_torch.weights slim slim_Final.pth slim.msgpack
    python -m facekit_torch.weights train-checkpoint ckpt/step_100 \
        trained.msgpack --num-classes 1000

The file it writes is the one ``facekit.weights`` writes, and both
packages load it (``rec_weights`` / ``det_weights``). ``train-checkpoint``
takes a checkpoint of the port's ``train.checkpoint.save_checkpoint`` and
writes its backbone. ``--verify`` builds the port's model from the written
file and runs one forward on ``--device`` (default ``cuda``; ``cpu`` to
run on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from facekit_torch.models import ArcFace, detector_family
from facekit_torch.utils.device import resolve_device
from facekit_torch.weights.bridge import from_jax, to_jax
from facekit_torch.weights.convert import (convert_arcface_state_dict,
                                           convert_lightdet_state_dict,
                                           convert_retinaface_state_dict,
                                           load_torch_checkpoint)
from facekit_torch.weights.io import load_params, save_params

def _verify(model: str, path: str, network: str, device) -> None:
    """The port's model from the written file, one forward on ``device``
    on random input, and its output stats (shape, finite, L2 norm)."""
    params = load_params(path)
    rng = np.random.default_rng(0)
    if model in ("arcface", "train-checkpoint"):
        net = ArcFace(network,
                      embed_dim=params["output"]["linear"]["w"].shape[0])
        x = rng.normal(0, 1, (1, 112, 112, 3))
    else:                        # retinaface, slim or rfb
        net = detector_family(model).build(params)
        x = rng.normal(0, 1, (1, 288, 320, 3) if model == "retinaface"
                       else (1, 320, 320, 3))
    net.load_state_dict(from_jax(params, net))
    net = net.to(device).eval()
    with torch.inference_mode():
        outs = net(torch.tensor(x, dtype=torch.float32, device=device))
    if model in ("arcface", "train-checkpoint"):
        out = outs.cpu().numpy()
        print(f"verify: emb {out.shape} finite={np.isfinite(out).all()} "
              f"norm={np.linalg.norm(out, axis=1)}")
    else:
        outs = [o.cpu().numpy() for o in outs if o is not None]
        print("verify:", [o.shape for o in outs],
              "finite =", all(np.isfinite(o).all() for o in outs))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("facekit_torch weight converter")
    ap.add_argument("model", choices=["arcface", "retinaface", "slim",
                                      "rfb", "train-checkpoint"])
    ap.add_argument("checkpoint",
                    help="reference torch .pth/.tar, or a train checkpoint "
                         "directory of facekit_torch for train-checkpoint")
    ap.add_argument("output")
    ap.add_argument("--network", default="ir_50",
                    help="arcface variant (ir_50/ir_101/ir_152/ir_se_50/...)")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="(train-checkpoint) classes the head was trained "
                         "with, needed to shape the restore template")
    ap.add_argument("--verify", action="store_true",
                    help="run the port's model from the written file on "
                         "random input and report output stats "
                         "(shape/finite/L2-norm)")
    ap.add_argument("--no-strict", action="store_true",
                    help="allow unconsumed checkpoint keys (by default the "
                         "converter refuses silent partial loads, like the "
                         "reference's check_keys)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --verify (default cuda; cpu to "
                         "run on the CPU)")
    args = ap.parse_args(argv)
    if args.model == "train-checkpoint" and not args.num_classes:
        ap.error("train-checkpoint requires --num-classes")
    device = resolve_device(args.device) if args.verify else None
    strict = not args.no_strict

    if args.model == "train-checkpoint":
        params = _trained_backbone(args.checkpoint, args.network,
                                   args.num_classes)
    else:
        params = _converted(args.model, args.checkpoint, args.network, strict)
    save_params(params, args.output)
    print(f"wrote {args.output}")

    if args.verify:
        if device.type == "cuda":
            # full f32, as FacePipeline runs its f32 compute
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _verify(args.model, args.output, args.network, device)


def _trained_backbone(path: str, network: str, num_classes: int):
    """The backbone of the port's train checkpoint at ``path`` as
    facekit's param tree, restored into a template of ``network`` with a
    ``num_classes`` head (``facekit/weights/__main__.py:43-56``)."""
    from facekit_torch.train import train_state_init
    from facekit_torch.train.checkpoint import restore_checkpoint

    template = train_state_init(num_classes, network=network, device="cpu")
    return to_jax(restore_checkpoint(path, template).params)


def _converted(model: str, path: str, network: str, strict: bool):
    """A reference torch checkpoint as facekit's param tree."""
    sd = load_torch_checkpoint(path)
    if model == "arcface":
        return convert_arcface_state_dict(sd, network, strict=strict)
    if model == "retinaface":
        return convert_retinaface_state_dict(sd, strict=strict)
    return convert_lightdet_state_dict(sd, model, strict=strict)


if __name__ == "__main__":
    main()
