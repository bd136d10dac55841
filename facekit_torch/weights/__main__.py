"""CLI: convert reference PyTorch checkpoints to param files.

The port's copy of ``facekit/weights/__main__.py``; it needs no JAX:

    python -m facekit_torch.weights arcface backbone_ir50_asia.pth arcface.msgpack
    python -m facekit_torch.weights retinaface mobilenet0.25_Final.pth retina.msgpack
    python -m facekit_torch.weights slim slim_Final.pth slim.msgpack

The file it writes is the one ``facekit.weights`` writes, and both
packages load it (``rec_weights`` / ``det_weights``). ``--verify`` builds
the port's model from the written file and runs one forward on
``--device`` (default ``cuda``; ``cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from facekit_torch.models import ArcFace, detector_family
from facekit_torch.utils.device import resolve_device
from facekit_torch.weights.bridge import from_jax
from facekit_torch.weights.convert import (convert_arcface_state_dict,
                                           convert_lightdet_state_dict,
                                           convert_retinaface_state_dict,
                                           load_torch_checkpoint)
from facekit_torch.weights.io import load_params, save_params

#: facekit's other converter mode, and the ROADMAP.md item that ports it
_NOT_PORTED = {"train-checkpoint": "Queue 1, train/"}


def _verify(model: str, path: str, network: str, device) -> None:
    """The port's model from the written file, one forward on ``device``
    on random input, and its output stats (shape, finite, L2 norm)."""
    params = load_params(path)
    rng = np.random.default_rng(0)
    if model == "arcface":
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
    if model == "arcface":
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
                                      "rfb", *_NOT_PORTED])
    ap.add_argument("checkpoint", help="reference torch .pth/.tar")
    ap.add_argument("output")
    ap.add_argument("--network", default="ir_50",
                    help="arcface variant (ir_50/ir_101/ir_152/ir_se_50/...)")
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
    if args.model in _NOT_PORTED:
        ap.error(f"{args.model} is not ported yet (ROADMAP.md "
                 f"{_NOT_PORTED[args.model]})")
    device = resolve_device(args.device) if args.verify else None
    strict = not args.no_strict

    sd = load_torch_checkpoint(args.checkpoint)
    if args.model == "arcface":
        params = convert_arcface_state_dict(sd, args.network, strict=strict)
    elif args.model == "retinaface":
        params = convert_retinaface_state_dict(sd, strict=strict)
    else:
        params = convert_lightdet_state_dict(sd, args.model, strict=strict)
    save_params(params, args.output)
    print(f"wrote {args.output}")

    if args.verify:
        if device.type == "cuda":
            # full f32, as FacePipeline runs its f32 compute
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _verify(args.model, args.output, args.network, device)


if __name__ == "__main__":
    main()
