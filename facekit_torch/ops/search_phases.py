"""Where the searches' tensor-core pass 1 spends its time, on the card.

Builds copies of ``cosine_topk.cu`` and ``cosine_topk_int8.cu`` whose
bf16 and s8 pass 1 (B > 8) carries timers at its phase boundaries (the
kernel itself carries no timing code), runs both searches at the top
gallery bucket and prints one JSON line per case: the mean and largest µs
per CTA of each phase (from the copy with timers), the mean CTA, the span
from the first CTA's start to the last one's end, and, from a copy built
as it is, ms per search by CUDA events and the host's µs to issue one::

    python -m facekit_torch.ops.search_phases [--source DIR]

``--source`` is an ``ops/csrc`` directory (default: this checkout's); the
copies are built under ``build/facekit_torch/phases/``. A recording thread
reads ``%globaltimer`` where the CTA starts and where it ends, and
``clock64`` at each phase boundary; a phase's cycles, summed over the
CTA's row tiles, are turned into µs by the CTA's own ratio of the two
clocks (``%globaltimer`` alone ticks too coarsely for a stage of a few
hundred ns). Two forms of the kernel are known, by their code:

  * the ``wgmma`` kernel (``topk_wgmma.cuh`` ``topk_partial_wgmma_kernel``),
    with two recorders: lane 0 of the wgmma warpgroup (setup, stage wait:
    its waits for a gallery stage; products: issuing the wgmma and waiting
    for them; score tile wait: for the selection warps to free a score
    tile; score store) and lane 0 of the first selection warp (score
    wait: for a tile of scores; selection);
  * the ``mma.sync`` kernel it replaced (``topk_mma.cuh``
    ``topk_partial_mma_kernel<T>``), thread 0 recording every phase in
    turn (setup, stage wait: ``cp.async`` wait, ``__syncthreads`` and the
    next stage's copies; products; score store; score tile wait: the
    ``__syncthreads`` after it; selection).

A source of neither form is refused. Both forms run the plan of this
checkout's ``_search_plan``, which neither changed. Needs a card and
``nvcc``; the outputs are held to the plain version (int8 bit for bit,
bf16 scores within 1e-4).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

from facekit_torch.ops import _build

N = 1 << 20                  # the top gallery bucket
# (dtype, B, k): the served batches (bf16 B = 32, int8 B = 64) and B = 256
CASES = [("bfloat16", 32, 1), ("bfloat16", 32, 64), ("bfloat16", 256, 1),
         ("bfloat16", 256, 64), ("int8", 64, 1), ("int8", 64, 64),
         ("int8", 256, 1), ("int8", 256, 64)]
PHASES = ["setup", "stage wait", "products", "score tile wait",
          "score store", "score wait", "selection"]
# slots a CTA: per recorder (globaltimer start, end, clock64 start, end),
# then the phases' cycles
RECORDERS = 2
SLOTS = 4 * RECORDERS + len(PHASES)

_TIMERS = r'''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long gt_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// a recorder's clocks: ph_t the last boundary, ph_rec whether it records
#define PH_BEGIN(on) \
  const bool ph_rec = (on) && g_stamps != nullptr; \
  unsigned long long ph_gt0 = 0, ph_t = 0, ph_c0 = 0; \
  if (ph_rec) { ph_gt0 = gt_now(); ph_t = ph_c0 = clock64(); }
// closes the time since the last mark as phase i (setup, phase 0, is the
// first recorder's alone)
#define PH(i) do { if (ph_rec) { const unsigned long long n_ = clock64(); \
  if ((i) != 0 || threadIdx.x == 0) \
    g_stamps[ph_cta() * SLOTS_ + 4 * RECORDERS_ + (i)] += n_ - ph_t; \
  ph_t = n_; } } while (0)
#define PH_END(r) do { if (ph_rec) { unsigned long long* s_ = g_stamps + \
  ph_cta() * SLOTS_ + 4 * (r); s_[0] = ph_gt0; s_[1] = gt_now(); s_[2] = ph_c0; \
  s_[3] = clock64(); } } while (0)
__device__ __forceinline__ size_t ph_cta() {
  return (size_t)blockIdx.y * gridDim.x + blockIdx.x;
}
'''
_EXPORT = r'''
extern "C" int facekit_search_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
'''

# (header, kernel's first line, edits: (anchor, text before it, text after
# it)) of each form; a phase's mark closes the time since the last mark
_WGMMA = ("topk_wgmma.cuh", "topk_partial_wgmma_kernel(", [
    ("  using P = WgTile<T>;\n", "", "  PH_BEGIN(threadIdx.x == 0 || threadIdx.x == 128)\n"),
    ("  if (warp == W_PRODUCER) {\n", "  PH(0);\n", ""),
    ("        mbar_wait(full + 8 * slot, phase);\n", "        PH(2);\n",
     "        PH(1);\n"),
    ("      if (t >= nsc) mbar_wait(sempty + 8 * b, (round - 1) & 1);\n",
     "      PH(2);\n", "      PH(3);\n"),
    ("      mbar_arrive(sfull + 8 * b);\n", "", "      PH(4);\n"),
    ("    mbar_wait(sfull + 8 * b, (t / nsc) & 1);\n", "    PH(6);\n",
     "    PH(5);\n"),
    ("    mbar_arrive(sempty + 8 * b);\n", "", "    PH(6);\n"),
    ("    return;\n  }\n\n  // the selection warps", "    PH_END(0);\n", ""),
    ("  for (int j = sw; j < nq; j += W_SEL_WARPS) {\n    const size_t off",
     "  PH(6);\n  PH_END(1);\n", ""),
])
_MMA_SYNC = ("topk_mma.cuh", "topk_partial_mma_kernel(", [
    ("  using Tile = MmaTile<T>;\n", "", "  PH_BEGIN(threadIdx.x == 0)\n"),
    ("#pragma unroll\n  for (int s = 0; s < MST - 1; ++s) {", "  PH(0);\n", ""),
    ("    if (++ld_buf == MST) ld_buf = 0;\n", "", "    PH(1);\n"),
    ("    if (++buf == MST) buf = 0;\n    if (ks < KSTAGES - 1) continue;\n",
     "    PH(2);\n", ""),
    ("    __syncthreads();\n    // each warp offers", "    PH(4);\n", ""),
    ("    // each warp offers the tile's rows", "    PH(3);\n", ""),
    ("  }\n  cp_async_wait<0>();\n", "    PH(6);\n", "  PH_END(0);\n"),
])


def form_of(csrc: Path):
    """The form of pass 1 in an ops/csrc directory: _WGMMA, _MMA_SYNC, or
    ValueError."""
    wg = csrc / "topk_wgmma.cuh"
    mma = csrc / "topk_mma.cuh"
    if wg.exists() and "topk_partial_wgmma_kernel(" in wg.read_text():
        return _WGMMA
    if mma.exists() and "mma_step(acc[i][j]" in mma.read_text() and \
            "template <typename T>\n__global__" in mma.read_text():
        return _MMA_SYNC
    raise ValueError(f"search_phases: {csrc} holds neither the wgmma nor the "
                     "mma.sync form of the searches' tensor-core pass 1")


def stamped_header(src: str, form) -> str:
    """The pass 1 header of ``form`` with its timers."""
    _, first, edits = form
    head = "namespace {\n"
    i = src.index(head)
    defs = (f"#define SLOTS_ {SLOTS}\n#define RECORDERS_ {RECORDERS}\n"
            + _TIMERS)
    out = src[:i] + defs + src[i:]
    start = out.index(first)
    for anchor, before, after in edits:
        if out.count(anchor) != 1 or out.index(anchor) < start:
            raise ValueError(f"search_phases: anchor {anchor[:40]!r} not "
                             "found once in the kernel")
        out = out.replace(anchor, before + anchor + after, 1)
    return out


def build(csrc: Path):
    """Builds both searches from ``csrc`` as they are and with timers;
    returns ({"bfloat16": (library, timed library), "int8": ...}, form,
    and ptxas's "wgmma ... serialized" warnings of the timed copies (a
    timer that serialized the wgmma would time another kernel))."""
    form = form_of(csrc)
    root = _build.BUILD_DIR / "phases" / ("wgmma" if form is _WGMMA
                                         else "mma_sync")
    if root.exists():
        shutil.rmtree(root)
    procs = {}
    for timed in (False, True):
        out_dir = root / ("timed" if timed else "plain")
        out_dir.mkdir(parents=True)
        for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
            shutil.copy(f, out_dir / f.name)
        if timed:
            header = out_dir / form[0]
            header.write_text(stamped_header(header.read_text(), form))
        for key, name in (("bfloat16", "cosine_topk"),
                          ("int8", "cosine_topk_int8")):
            cu = out_dir / f"{name}.cu"
            if timed:
                cu.write_text(cu.read_text() + _EXPORT)
            lib = out_dir / f"lib{name}.so"
            procs[key, timed] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{out_dir}", "-o",
                 str(lib), "-Xptxas", "-v", str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), lib)
    serialized, built = [], {}
    for (key, timed), (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({key}):\n{log}")
        if timed:
            serialized += [line.strip() for line in log.splitlines()
                           if "wgmma" in line and "serialized" in line]
        built[key, timed] = ctypes.CDLL(str(lib))
    libs = {key: (built[key, False], built[key, True])
            for key in ("bfloat16", "int8")}
    return libs, form, serialized


def _entry(lib, key, form):
    """The library's C entry point with the argument types of its form
    (the wgmma form passes the gallery's rows for its tensor map)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    rows = [i] if form is _WGMMA else []
    if key == "int8":
        fn = lib.facekit_cosine_topk_int8
        fn.argtypes = [p, p, p, p, *rows, i, i, i, i, i, i, p, p, p, p, p]
    else:
        fn = lib.facekit_cosine_topk
        fn.argtypes = [p, p, i, *rows, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _phase_stats(st, nctas, form):
    """Per-CTA µs of each phase (mean, max) from the stamps of ``nctas``
    CTAs, each phase in the clocks of the recorder that marks it (in the
    wgmma form the selection warp marks score wait and selection), and the
    mean CTA and the span in µs."""
    import torch
    t = st.view(nctas, SLOTS).double().cpu()
    t = t[t[:, 0] > 0]
    cyc = t[:, 4 * RECORDERS:]
    owner = [0] * len(PHASES)
    if form is _WGMMA:
        owner[PHASES.index("score wait")] = owner[PHASES.index("selection")] = 1
    us_per_cycle = torch.stack([
        (t[:, 4 * r + 1] - t[:, 4 * r]) / (t[:, 4 * r + 3] - t[:, 4 * r + 2])
        .clamp(min=1) / 1e3 for r in range(RECORDERS)], 1)
    us = cyc * us_per_cycle[:, owner]
    ends = t[:, [4 * r + 1 for r in range(RECORDERS)]].max(1)[0]
    return {"ctas": int(t.shape[0]),
            "phase_us_mean": [float(v) for v in us.mean(0)],
            "phase_us_max": [float(v) for v in us.max(0)[0]],
            "cta_us_mean": float(((ends - t[:, 0]) / 1e3).mean()),
            "span_us": float((ends.max() - t[:, 0].min()) / 1e3)}


def run(csrc: Path, cases=CASES, seed: int = 13):
    import torch

    from facekit_torch.ops.similarity import (_mma_queries, _search_plan,
                                              _sms, cosine_topk_int8_reference,
                                              cosine_topk_reference,
                                              quantize_rows_int8)
    libs, form, serialized = build(csrc)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def unit_rows(rows):
        x = torch.randn((rows, 512), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    g32 = unit_rows(N)
    gallery = {"bfloat16": g32.bfloat16()}
    gallery["int8"] = quantize_rows_int8(g32)
    del g32
    count = N - 37
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    for key, b, k in cases:
        lib, timed = libs[key]
        fns = {lib_: _entry(lib_, key, form) for lib_ in (lib, timed)}
        timed.facekit_search_stamps.argtypes = [ctypes.c_void_p]
        n_rows = min(N, count + k)
        dtype = torch.int8 if key == "int8" else torch.bfloat16
        rows_per_cta, chunks = _search_plan(n_rows, b, _mma_queries(dtype, b),
                                            _sms(dev), k)
        q = unit_rows(b)
        part_v = torch.empty((b, chunks, k), device=dev)
        part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
        out_v = torch.empty((b, k), device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rows = [N] if form is _WGMMA else []
        if key == "int8":
            gq, gs = gallery["int8"]
            qq, qs = quantize_rows_int8(q)
            args = [gq.data_ptr(), gs.data_ptr(), qq.data_ptr(), qs.data_ptr(),
                    *rows]
            plain = cosine_topk_int8_reference(gq, gs, q, count, k)
        else:
            qb = q.bfloat16()
            args = [gallery[key].data_ptr(), qb.data_ptr(), 1, *rows]
            plain = cosine_topk_reference(gallery[key], qb, count, k)
        args += [n_rows, count, b, k, rows_per_cta, chunks, part_v.data_ptr(),
                 part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream]

        def launch(lib_=lib):
            err = fns[lib_](*args)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        timed.facekit_search_stamps(None)
        for lib_ in (timed, lib):
            launch(lib_)
            torch.cuda.synchronize()
            err = float((out_v - plain[0]).abs().max())
            if (key == "int8" and not (torch.equal(out_v, plain[0])
                                       and torch.equal(out_i, plain[1]))) \
                    or err > 1e-4:
                raise AssertionError(f"{key} B={b} k={k}: differs from the "
                                     f"plain version (max score error {err})")
        for _ in range(2):
            launch()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            launch()
        e1.record()
        torch.cuda.synchronize()
        # the host's µs to issue a search on an idle card (a hit of the
        # wgmma form's tensor-map cache included)
        host = []
        for _ in range(22):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            launch()
            host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        nctas = -(-b // 64) * chunks
        st = torch.zeros(nctas * SLOTS, dtype=torch.int64, device=dev)
        timed.facekit_search_stamps(st.data_ptr())
        launch(timed)
        torch.cuda.synchronize()
        timed.facekit_search_stamps(None)
        print(json.dumps({
            "phase": "search_phases", "source": str(csrc),
            "form": "wgmma" if form is _WGMMA else "mma.sync",
            "dtype": key, "N": N, "count": count, "B": b, "k": k,
            "chunks": chunks, "rows_per_cta": rows_per_cta,
            "ms": e0.elapsed_time(e1) / 20,
            "host_us": statistics.median(host[2:]), "max_abs_err": err,
            "phases": PHASES, **_phase_stats(st, nctas, form),
            "serialized_wgmma": serialized,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": power}),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=Path(__file__).resolve().parent / "csrc")
    args = ap.parse_args(argv)
    run(args.source.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
