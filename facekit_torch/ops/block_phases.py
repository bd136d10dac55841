"""Where the fused IR block's bf16 kernel spends its time, on the card.

Builds a copy of an ``ir_block.cu`` with a ``%globaltimer`` stamp at each
phase boundary of every CTA (the kernel itself carries no timing code),
runs it at IR-50's four identity-block shapes and prints one JSON line per
shape and batch: the mean and largest µs per CTA of each phase, the mean
CTA, the span from the first CTA's start to the last one's end, and ms per
launch by CUDA events without the stamps::

    python -m facekit_torch.ops.block_phases [--source PATH] [--batches 8 64]

``--source`` is an ``ir_block.cu`` (default: this checkout's); its headers
come from the same directory, and the library is built under
``build/facekit_torch/phases/``. Two forms of the kernel are known, by
the code at their phase boundaries: the ``wgmma`` kernel (phases: t
built and gathered, conv1, cluster barrier 1, the bulk copies of u, conv2,
the staged epilogue with the last cluster barrier; a stamp after a conv
takes a barrier of the consumer warps) and the
``mma.sync`` kernel it replaced (t built, conv1 with its epilogue,
barrier 1, gather and barrier 2, conv2 with its epilogue; a
``__syncthreads`` before each stamp). A source of neither form is
refused. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from facekit_torch.ops import _build

SHAPES = [(56, 64), (28, 128), (14, 256), (7, 512)]   # IR-50's (H = W, C)
_STAMPS = r'''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0 && g_stamps) \
  g_stamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NSTAMPS + (k)] = \
      stamp_now(); } while (0)
'''
_EXPORT = r'''
extern "C" int facekit_ir_block_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
'''
# (anchor, text put before it, text put after it) of each form
_WGMMA = ("wgmma", 7, ["t built + gathered", "conv1", "cluster barrier 1",
                       "u copies", "conv2", "epilogue"], [
    ("  if (threadIdx.x == 0) {\n    for (int i = 0; i < NST; ++i) {",
     "  STAMP(0);\n", ""),
    ("  // conv1: u on image rows", "  STAMP(1);\n", ""),
    ("  fence_proxy_async();\n  cluster.sync();                   // every u",
     "  consumers_sync();\n  STAMP(2);\n", ""),
    ("  if (G > 1) {\n    if (warp == 0 && lane < G)\n", "  STAMP(3);\n", ""),
    ("  // conv2: the output on image rows", "  STAMP(4);\n", ""),
    ("  // out = bf16(m2*s2 + b2 + f32(x)) through", "  STAMP(5);\n", ""),
])
_MMA_SYNC = ("mma.sync", 6, ["t built", "conv1", "cluster barrier 1",
                             "u gather + barrier 2", "conv2"], [
    ("  const bf16* xn = x + (size_t)n * H * W * C;\n  const float* s1 = par;",
     "  __syncthreads();\n  STAMP(0);\n", ""),
    ("  // (conv_mma's first __syncthreads publishes t)",
     "  __syncthreads();\n  STAMP(1);\n", ""),
    ("  cluster.sync();                   // every u slice is written; "
     "the ring and", "  __syncthreads();\n  STAMP(2);\n", ""),
    ("  // all C channels of u on the R+2 rows (zero columns included)",
     "  STAMP(3);\n", ""),
    ("  // out on image rows r0 .. r0+R-1, this CTA's channels: bn2",
     "  STAMP(4);\n", ""),
])


def stamped_source(src: str):
    """(source with stamps, stamps a CTA, phase names) of an ir_block.cu."""
    if "conv_pass_n(" in src:
        form = _WGMMA
    elif "conv_mma(" in src:
        form = _MMA_SYNC
    else:
        raise ValueError("block_phases: neither the wgmma nor the mma.sync "
                         "form of ir_block.cu")
    _, nstamps, names, edits = form
    head = "namespace cg = cooperative_groups;\n"
    out = src.replace(head, head + f"#define NSTAMPS {nstamps}\n" + _STAMPS, 1)
    for anchor, before, after in edits:
        if out.count(anchor) != 1:
            raise ValueError(f"block_phases: anchor {anchor[:40]!r} not "
                             "found once")
        out = out.replace(anchor, before + anchor + after, 1)
    # the last stamp: at the end of the bf16 kernel, after its epilogue
    start = out.index("ir_block_bf16_kernel(")
    end = out.index("\n}\n", start)
    last = ("  consumers_sync();\n" if form is _WGMMA else
            "  __syncthreads();\n") + f"  STAMP({nstamps - 1});"
    out = out[:end] + "\n" + last + out[end:]
    return out + _EXPORT, nstamps, names


def build(source: Path) -> tuple:
    """Builds the stamped copy of ``source``; (library, stamps, names)."""
    text, nstamps, names = stamped_source(source.read_text())
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "ir_block_stamped.cu"
    cu.write_text(text)
    lib = out_dir / "libir_block_phases.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{source.parent}", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib)), nstamps, names


def _operands(c, gen, dev):
    """Random (w1, w2, par) of a block of c channels: weights uniform in
    +-sqrt(6 / 9c), BN scales near 1."""
    import torch
    a = (6.0 / (9 * c)) ** 0.5
    w1, w2 = ((torch.rand((c, 3, 3, c), generator=gen) * 2 - 1) * a
              for _ in range(2))
    par = torch.stack([torch.rand(c, generator=gen) + 0.5,
                       torch.rand(c, generator=gen) * 0.4 - 0.2,
                       torch.rand(c, generator=gen) * 0.3 + 0.1,
                       torch.rand(c, generator=gen) + 0.5,
                       torch.rand(c, generator=gen) * 0.4 - 0.2])
    return (w1.bfloat16().to(dev), w2.bfloat16().to(dev),
            par.float().contiguous().to(dev))


def run(source: Path, batches, seed: int = 5):
    import torch
    lib, nstamps, names = build(source)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.facekit_ir_block
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    lib.facekit_ir_block_stamps.argtypes = [p]
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    for hw, c in SHAPES:
        w1, w2, par = _operands(c, gen, dev)
        for n in batches:
            x = torch.randn(n, hw, hw, c, device=dev).bfloat16()
            out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                         par.data_ptr(), out.data_ptr(), n, hw, hw, c, 1,
                         stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            lib.facekit_ir_block_stamps(None)
            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                launch()
            e1.record()
            torch.cuda.synchronize()
            # room for one CTA per image row and 64 channels, the most any
            # band height gives; the CTAs that ran wrote their first stamp
            st = torch.zeros(hw * (c // 64) * n * nstamps, dtype=torch.int64,
                             device=dev)
            lib.facekit_ir_block_stamps(st.data_ptr())
            launch()
            torch.cuda.synchronize()
            lib.facekit_ir_block_stamps(None)
            t = st.view(-1, nstamps).double().cpu()
            t = t[t[:, 0] > 0]
            d = (t[:, 1:] - t[:, :-1]) / 1e3
            print(json.dumps({
                "phase": "block_phases", "source": str(source),
                "N": n, "H": hw, "W": hw, "C": c, "ctas": int(t.shape[0]),
                "ms": e0.elapsed_time(e1) / 20, "phases": names,
                "phase_us_mean": [float(v) for v in d.mean(0)],
                "phase_us_max": [float(v) for v in d.max(0)[0]],
                "cta_us_mean": float((t[:, -1] - t[:, 0]).mean() / 1e3),
                "span_us": float((t[:, -1].max() - t[:, 0].min()) / 1e3),
                "device": torch.cuda.get_device_name(0)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=Path(__file__).resolve().parent / "csrc"
                    / "ir_block.cu")
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    args = ap.parse_args(argv)
    run(args.source.resolve(), args.batches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
