"""Where the searches' tensor-core pass 1 spends its time, on the card.

Builds copies of ``cosine_topk.cu`` and ``cosine_topk_int8.cu`` whose
pass 1 at B > 8 carries timers at its phase boundaries (the kernels
themselves carry no timing code), runs the searches at the top gallery
bucket and prints one JSON line per case: the mean and largest µs per CTA
of each phase (from the copy with timers), the mean CTA, the span from the
first CTA's start to the last one's end, and, from a copy built as it is,
ms per search by CUDA events and the host's µs to issue one::

    python -m facekit_torch.ops.search_phases [--source DIR] [--dtype T ...]

``--source`` is an ``ops/csrc`` directory (default: this checkout's);
``--dtype`` (bfloat16, float32, int8; repeatable) keeps only those cases.
The copies are built under ``build/facekit_torch/phases/<digest of the
sources>/``. A recording
thread reads ``%globaltimer`` where the CTA starts and where it ends, and
``clock64`` at each phase boundary; a phase's cycles, summed over the
CTA's row tiles, are turned into µs by the CTA's own ratio of the two
clocks (``%globaltimer`` alone ticks too coarsely for a stage of a few
hundred ns). The forms of the kernel known, by their code, each for the
operand types it runs:

  * the ``wgmma`` kernel of all three types (``topk_wgmma.cuh``
    ``topk_partial_wgmma_kernel<T>``, f32 as 3xTF32 with the gallery as
    A from registers), and the same kernel before f32 joined it (bf16 and
    s8 only), with two recorders: lane 0 of the first consumer warp
    (setup, stage wait: its waits for a gallery stage; products: in f32
    also loading and splitting its A fragments; score tile wait: for the
    selection warps to free a score tile; score store) and lane 0 of the
    first selection warp (score wait: for a tile of scores; selection);
  * the ``mma.sync`` kernels: one template over the three types
    (``topk_mma.cuh`` ``topk_partial_mma_kernel<T>``), and the f32-only
    3xTF32 kernel that the wgmma kernel of all three types replaced
    (``topk_mma.cuh`` ``topk_partial_mma_kernel``, ``MmaTile``), thread 0
    recording every phase in turn (setup, stage wait: ``cp.async`` wait,
    ``__syncthreads`` and the next stage's copies; products; score store;
    score tile wait: the ``__syncthreads`` after it; selection).

A type whose pass 1 is of no known form is refused. Every form runs the
plan of this checkout's ``_search_plan`` and ``_mma_queries``, which none
of them changed. Needs a card and ``nvcc``; the outputs are held to the
plain version (int8 bit for bit, bf16 scores within 1e-4, f32 within
1e-5).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

from facekit_torch.ops import _build

N = 1 << 20                  # the top gallery bucket
# (dtype, B, k): the served batches (bf16 B = 32, int8 B = 64), B = 256,
# and f32 (a gallery_dtype "float32" store) at B = 32 and 256
CASES = [("bfloat16", 32, 1), ("bfloat16", 32, 64), ("bfloat16", 256, 1),
         ("bfloat16", 256, 64), ("int8", 64, 1), ("int8", 64, 64),
         ("int8", 256, 1), ("int8", 256, 64), ("float32", 32, 1),
         ("float32", 256, 1), ("float32", 256, 64)]
DTYPES = ("bfloat16", "int8", "float32")
PHASES = ["setup", "stage wait", "products", "score tile wait",
          "score store", "score wait", "selection"]
# slots a CTA: per recorder (globaltimer start, end, clock64 start, end),
# then the phases' cycles
RECORDERS = 2
SLOTS = 4 * RECORDERS + len(PHASES)

_TIMERS = r"""
#ifndef FACEKIT_PH_TIMERS
#define FACEKIT_PH_TIMERS
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
#endif
"""
_EXPORT = r"""
extern "C" int facekit_search_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
"""

# (header, kernel's first line, edits: (anchor, text before it, text after
# it)) of each form; a phase's mark closes the time since the last mark
_WGMMA = ("topk_wgmma.cuh", "topk_partial_wgmma_kernel(", [
    ("  using Acc = typename P::Acc;\n", "",
     "  PH_BEGIN(threadIdx.x == 0 || threadIdx.x == P::MMA_THREADS)\n"),
    ("  if (warp == P::PRODUCER) {\n", "  PH(0);\n", ""),
    # f32: a stage's A fragments loaded and split, its wgmma issued
    ("        mbar_wait(full + 8 * slot, phase);\n"
     "        const unsigned char* st", "        PH(2);\n", ""),
    ("        const unsigned char* st = ", "        PH(1);\n", ""),
    # bf16 and s8: a stage of both operands from shared memory
    ("          mbar_wait(full + 8 * slot, phase);\n"
     "          const uint32_t st", "          PH(2);\n", ""),
    ("          const uint32_t st = ring", "          PH(1);\n", ""),
    # the score tile hand-off that all three types share
    ("      if (t >= nsc) mbar_wait(sempty + 8 * b, (t / nsc - 1) & 1);\n",
     "      PH(2);\n", "      PH(3);\n"),
    ("      mbar_arrive(sfull + 8 * b);\n", "", "      PH(4);\n"),
    ("    mbar_wait(sfull + 8 * b, (t / nsc) & 1);\n", "    PH(6);\n",
     "    PH(5);\n"),
    ("    mbar_arrive(sempty + 8 * b);\n", "", "    PH(6);\n"),
    ("    return;\n  }\n\n  // the selection warps", "    PH_END(0);\n", ""),
    ("  for (int j = sw; j < nq; j += P::SEL_WARPS) {\n    const size_t off",
     "  PH(6);\n  PH_END(1);\n", ""),
])
# the wgmma kernel of bf16 and s8 alone (f32 then ran the f32-only form)
_WGMMA_BF16_S8 = ("topk_wgmma.cuh", "topk_partial_wgmma_kernel(", [
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
# the f32-only 3xTF32 mma.sync kernel: _MMA_SYNC's phases, no template
_MMA_F32 = ("topk_mma.cuh", "topk_partial_mma_kernel(", [
    ("  using Tile = MmaTile;\n", "", "  PH_BEGIN(threadIdx.x == 0)\n"),
    *_MMA_SYNC[2][1:]])
# the forms whose selection runs on warps of its own (recorder 1)
_SELECTION_WARPS = (_WGMMA, _WGMMA_BF16_S8)
NAMES = {id(_WGMMA): "wgmma", id(_WGMMA_BF16_S8): "wgmma (bf16, s8)",
         id(_MMA_SYNC): "mma.sync", id(_MMA_F32): "mma.sync (f32)"}


def form_of(csrc: Path, dtype: str = "bfloat16"):
    """The form of the tensor-core pass 1 that the ``dtype`` search
    (bfloat16, int8 or float32) runs in an ops/csrc directory, or
    ValueError."""
    def text(name):
        f = csrc / name
        return f.read_text() if f.exists() else ""
    wg, mma = text("topk_wgmma.cuh"), text("topk_mma.cuh")
    wg_kernel = "topk_partial_wgmma_kernel(" in wg
    if dtype == "float32":
        if wg_kernel and "wgmma_tf32<" in wg:
            return _WGMMA
        if "topk_partial_mma_kernel(" in mma and "using Tile = MmaTile;" in mma:
            return _MMA_F32
    elif wg_kernel:
        return _WGMMA if "wgmma_tf32<" in wg else _WGMMA_BF16_S8
    if "mma_step(acc[i][j]" in mma and "template <typename T>\n__global__" in mma:
        return _MMA_SYNC
    raise ValueError(f"search_phases: {csrc} holds neither a wgmma nor an "
                     f"mma.sync form of the {dtype} search's tensor-core "
                     "pass 1")


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


def build(csrc: Path, dtypes=DTYPES):
    """Builds the searches of ``dtypes`` from ``csrc`` as they are and with
    timers; returns ({dtype: (library, timed library)}, {dtype: form},
    and ptxas's "wgmma ... serialized" warnings of the timed copies (a
    timer that serialized the wgmma would time another kernel))."""
    forms = {d: form_of(csrc, d) for d in dtypes}
    # a directory of the sources' own: a process that loads two builds
    # from one path gets the first library again
    sources = sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")))
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in sources))
    root = _build.BUILD_DIR / "phases" / digest.hexdigest()[:12]
    if root.exists():
        shutil.rmtree(root)
    names = {"bfloat16": "cosine_topk", "float32": "cosine_topk",
             "int8": "cosine_topk_int8"}
    procs = {}
    for timed in (False, True):
        out_dir = root / ("timed" if timed else "plain")
        out_dir.mkdir(parents=True)
        for f in sources:
            shutil.copy(f, out_dir / f.name)
        if timed:
            for form in {id(f): f for f in forms.values()}.values():
                header = out_dir / form[0]
                header.write_text(stamped_header(header.read_text(), form))
        for name in sorted({names[d] for d in dtypes}):
            cu = out_dir / f"{name}.cu"
            if timed:
                cu.write_text(cu.read_text() + _EXPORT)
            lib = out_dir / f"lib{name}.so"
            procs[name, timed] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{out_dir}", "-o",
                 str(lib), "-Xptxas", "-v", str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), lib)
    serialized, built = [], {}
    for (name, timed), (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{log}")
        if timed:
            serialized += [line.strip() for line in log.splitlines()
                           if "wgmma" in line and "serialized" in line]
        built[name, timed] = ctypes.CDLL(str(lib))
    libs = {d: (built[names[d], False], built[names[d], True])
            for d in dtypes}
    return libs, forms, serialized


def _entry(lib, key, rows):
    """The library's C entry point; ``rows``: whether it takes the
    gallery's rows (for the wgmma kernel's tensor map)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    rows = [i] if rows else []
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
    wgmma forms the selection warp marks score wait and selection), and
    the mean CTA and the span in µs."""
    import torch
    t = st.view(nctas, SLOTS).double().cpu()
    t = t[t[:, 0] > 0]
    cyc = t[:, 4 * RECORDERS:]
    owner = [0] * len(PHASES)
    if any(form is f for f in _SELECTION_WARPS):
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
    dtypes = tuple(d for d in DTYPES if any(c[0] == d for c in cases))
    libs, forms, serialized = build(csrc, dtypes)
    takes_rows = {key: "int gallery_rows" in (csrc / f"{name}.cu").read_text()
                  for key, name in (("bfloat16", "cosine_topk"),
                                    ("float32", "cosine_topk"),
                                    ("int8", "cosine_topk_int8"))}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def unit_rows(rows):
        x = torch.randn((rows, 512), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    g32 = unit_rows(N)
    gallery = {}
    if "bfloat16" in dtypes:
        gallery["bfloat16"] = g32.bfloat16()
    if "int8" in dtypes:
        gallery["int8"] = quantize_rows_int8(g32)
    if "float32" in dtypes:
        gallery["float32"] = g32
    del g32
    count = N - 37
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    for key, b, k in cases:
        lib, timed = libs[key]
        form = forms[key]
        fns = {lib_: _entry(lib_, key, takes_rows[key])
               for lib_ in (lib, timed)}
        timed.facekit_search_stamps.argtypes = [ctypes.c_void_p]
        n_rows = min(N, count + k)
        dtype = getattr(torch, key)
        per_cta = _mma_queries(dtype, b)
        rows_per_cta, chunks = _search_plan(n_rows, b, per_cta, _sms(dev), k)
        q = unit_rows(b)
        part_v = torch.empty((b, chunks, k), device=dev)
        part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
        out_v = torch.empty((b, k), device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rows = [N] if takes_rows[key] else []
        if key == "int8":
            gq, gs = gallery["int8"]
            qq, qs = quantize_rows_int8(q)
            args = [gq.data_ptr(), gs.data_ptr(), qq.data_ptr(), qs.data_ptr(),
                    *rows]
            plain = cosine_topk_int8_reference(gq, gs, q, count, k)
        else:
            qd = q.to(dtype)
            args = [gallery[key].data_ptr(), qd.data_ptr(),
                    int(key == "bfloat16"), *rows]
            plain = cosine_topk_reference(gallery[key], qd, count, k)
        args += [n_rows, count, b, k, rows_per_cta, chunks, part_v.data_ptr(),
                 part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream]
        atol = 1e-5 if key == "float32" else 1e-4

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
                    or err > atol:
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
        nctas = -(-b // per_cta) * chunks
        st = torch.zeros(nctas * SLOTS, dtype=torch.int64, device=dev)
        timed.facekit_search_stamps(st.data_ptr())
        launch(timed)
        torch.cuda.synchronize()
        timed.facekit_search_stamps(None)
        print(json.dumps({
            "phase": "search_phases", "source": str(csrc),
            "form": NAMES[id(form)],
            "dtype": key, "N": N, "count": count, "B": b, "k": k,
            "chunks": chunks, "rows_per_cta": rows_per_cta,
            "queries_per_cta": per_cta,
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
    ap.add_argument("--dtype", action="append", choices=DTYPES,
                    help="keep only this type's cases (repeatable)")
    args = ap.parse_args(argv)
    cases = [c for c in CASES if not args.dtype or c[0] in args.dtype]
    run(args.source.resolve(), cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
