#!/usr/bin/env python3
"""Smoke test of facekit_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's four CUDA kernels from this checkout (and checks the
``ptxas -v`` lines of the searches' and the conv's kernels) and holds
each against its plain PyTorch version: the bf16/f32 and the int8 gallery
searches at the top gallery bucket (N = 1,048,576; each timed case also
split into pass 1 and pass 2 by a ``torch.profiler`` trace; 70 copies of
a row checked at the k = 64 cutoff; both at 257 and 512 queries), the
s8 convolution at every conv shape of the int8 IR-50 at batches 1, 8 and
64 (with the host's and the card's time per call, and per-forward sums)
and at the TPU kernel's own shape, the fused IR block at IR-50's four
identity-block shapes (batch 8 and 64, bf16 and f32, and batch 32 in
bf16). It traces the throughput config's int8 IR-50 forward back to back
at batches 1, 8 and 64 (host time, device operations, the card's idle
share). Then it drives three serving paths on the card and checks what
comes out: /recognize + enrollment of configs/default.json (IR-50,
bf16), the same for configs/throughput.json (int8 IR-50, int8 gallery,
batches of 1, 8 and 64) with dynamic and with calibrated activation
scales, and WS /inference of configs/default.json (480x640 frames ->
RetinaFace -> alignment -> IR-50 -> search, buckets 1 and 8), stage by
stage against the port's CPU path, and ``server_detectors``: the same WS
path and an uncropped /insert/face with the slim detector (bf16) and
the int8 RFB and RetinaFace detectors (``det_quantize``), each int8
site's sum held to the plain conv on the card's own input, and one
``conv_s8_det_case`` line per distinct detector site shape (the
depthwise route and the 8- to 32-channel outputs among them). Last,
``weights_gen``: the default
config's IR-50 and RetinaFace written as reference-layout checkpoints,
converted by ``python -m facekit_torch.weights --verify`` on the card,
a folder of crops enrolled by ``main()`` in gen mode (rows bit-equal to
a server given the original tree), every crop recognized through the
app, and ``/probe/device``; then ``server_engines``: both shipped
configs exported by ``python -m facekit_torch.engine export`` on the
card, a ``FaceServer`` booted from each directory, its WS /inference and
/recognize replies, embeddings and kernel launches held to the same
server's eager pipeline at every bucket, boot, export and latency beside
eager, and the registered ops' cost per call (``dispatch_cost``); then
``server_remainder``: configs/default.json served on the native pixel
backend (``server_hostOps: "native"``), its replies, crops and
similarities bit-equal to the cv2 server's on JPEG payloads, a PNG
answered "null", host decode µs and WS round trips of both (or, where
the native library cannot be built, the server's refusal with the
build's message); configs/throughput.json calibrated with
``rec_int8Residual``, every site of a forward bit-equal to the plain
conv, its drift from the f32 embedder against calibrated int8's, device
ms and operations per forward and ``/recognize`` latency of both, and a
residual engine pair served at bucket 1, bit-equal to eager; and
``warp_align_frames(slice_win=320)`` bit-identical to the full path;
then ``train``: IR-50 trained at batch 64 on synthetic identities by the
port's ``train_state_init`` / ``make_train_step`` in bf16 and in f32
(TF32 off), each with and without ``remat`` (losses, step ms by CUDA
events, peak memory, every leaf with a gradient, no kernel launched by a
step), the trained state through ``save_checkpoint`` and ``python -m
facekit_torch.weights train-checkpoint`` into a configs/default.json
server that recognizes held-out samples, and a server with
``rec_outputDim: 256`` (the searches at D = 256).
Each path runs with every kernel's launch
count set to 0 just before it and read just after. Prints one
JSON line per phase, the ``kernels`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero; nothing falls back to the CPU or to a plain
version. Without CUDA it exits non-zero and prints no result. Imports
nothing of JAX. ``python3 chip_smoke.py --searches`` runs the build and
the two search phases alone, for comparing search kernels; ``--convs``
the conv's build, its ``ptxas`` line and the conv phase alone;
``--throughput`` the int8 forward and the throughput config's /recognize
path alone (it runs on an older checkout too, to compare the two in one
call); ``--gen`` the build of the two kernels it runs and
``weights_gen`` alone; ``--detectors`` the build of the three kernels
it runs, the conv's ``ptxas`` line and ``server_detectors`` alone;
``--engines`` the build and ``server_engines`` alone; ``--remainder``
the build and ``server_remainder`` alone; ``--train`` the build of the
two kernels it serves with and ``train`` alone. ``weights_gen``,
``server_detectors`` and ``server_remainder`` serve through aiohttp.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_TOP = 1 << 20          # top bucket of the default gallery ladder
DIM = 512
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
# NVIDIA H100 SXM data sheet, dense rates at 700 W
PEAK_OPS = {"bfloat16": 989e12,               # tensor cores
            "float32": 67e12,                 # FP32, outside the tensor cores
            "int8": 1979e12}                  # tensor cores
# An f32 search needs f32-grade products; the least time for them on this
# card is three TF32 passes (3xTF32) at the dense TF32 tensor-core peak
# (NVIDIA H100 SXM data sheet, 495 TFLOPS at 700 W), below the FP32 CUDA
# cores' 67 TFLOPS. search_bound uses it for every f32 case.
TF32_PEAK_OPS = 495e12
F32_TF32_PASSES = 3
SCORE_ATOL = 1e-4        # f32 sums over D=512 in another order
SPLIT_REPS = 5           # searches traced per case for the pass split
TRACE_TRIES = 3          # traces taken until one holds every call's events
L2_FLUSH_BYTES = 256 << 20   # > the H100's 50 MB L2, overwritten per call
# the cutoff-tie check: copies of one row per query, each in its own
# chunk; the top k must be the k lowest indices of the copies
TIE_COPIES = 70
# what the kernels line keeps of each B <= 8, k = 64 search case
SMALL_BATCH_KEYS = ("dtype", "B", "k", "ms", "library_ms", "bound_ms",
                    "bound_by", "pass1_us", "pass2_us", "other_us")
# registers of the bf16 tensor-core search pass 1 before the s8 search
# shared it (ptxas -v, sm_90a); the shared kernel must not take more
MMA_BF16_REGISTERS = 72
COS_DIST_MAX = 1e-3      # bf16 embeddings vs f32 (BASELINE.json north star)
INT8_COS_DIST_MAX = 5e-3  # int8 embeddings vs f32 (facekit's own int8 bar,
#                           tests/test_model_parity.py:158-175)
SITES_PER_FORWARD = 52   # int8 IR-50: stem, 24 x (conv1, conv2), 3 shortcuts
KERNEL4_SHAPE = (256, 112, 112, 64, 64, 3, 2, 1)   # N, H, W, C, O, k, s, p
# batches of conv_s8_case: the throughput config's /recognize buckets
CONV_BATCHES = (1, 8, 64)
# search batches past 256 queries (a top bucket above 64 frames, or more
# than 4 faces a frame, on WS /inference)
BIG_BATCHES = (257, 512)
FORWARD_REPS = 10        # int8 IR-50 forwards timed and traced per batch
IR_BLOCKS_PER_FORWARD = 20   # float IR-50's stride-1 identity blocks
# (H = W, C, blocks per forward) of those blocks
IR_BLOCK_SHAPES = [(56, 64, 2), (28, 128, 3), (14, 256, 13), (7, 512, 2)]
# batches of ir_block_case: 8 and 64, and in bf16 32, the forward WS
# /inference runs at bucket 8 (8 frames x 4 faces)
IR_BLOCK_BATCHES = {"bfloat16": (8, 32, 64), "float32": (8, 64)}
IR_BLOCK_F32_ATOL = 1e-4     # f32 sums over 9*C terms in another order
IR_BLOCK_BF16_PAST = 1e-5    # share of bf16 outputs allowed past two steps
DET_ATOL = {"loc": 1e-2, "conf": 2e-3, "ldm": 1e-2}  # bf16 vs f32 detector
CROP_ATOL = 2.0              # aligned crops, 0..255 scale (bf16 passes)


# the train phase: IR-50 at batch 64, one synthetic identity a sample
TRAIN_BATCH = 64
TRAIN_STEPS = 6          # steps on one fixed batch, the first a warm-up
TRAIN_REMAT_STEPS = 3
# facekit's round-trip test trains ir_tiny at 3e-3; IR-50 (BN in
# inference form, a trained leaf like any other) rose from its first step
# there, and at 1e-4 fell at each of 5 steps (the port on the CPU, batch 8)
TRAIN_LR = 1e-4
TRAIN_QUERIES = 2        # held-out samples per identity, recognized


def _wrappers():
    from facekit_torch.ops.conv_s8 import conv_s8
    from facekit_torch.ops.ir_block import ir_block
    from facekit_torch.ops.similarity import cosine_topk, cosine_topk_int8
    return {"cosine_topk": cosine_topk, "cosine_topk_int8": cosine_topk_int8,
            "conv_s8": conv_s8, "ir_block": ir_block}


def reset_launches():
    """Every kernel's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


@contextlib.contextmanager
def composed_blocks():
    """Every IR block op by op (cuDNN convs), as the port ran them before
    the fused kernel: a guide to what the kernel changes end to end."""
    from facekit_torch.models.arcface import IRBlock
    fusable = IRBlock.fusable
    IRBlock.fusable = lambda self: False
    try:
        yield
    finally:
        IRBlock.fusable = fusable


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, args_list, iters: int) -> float:
    """Mean ms of ``fn(*args)`` over ``iters`` launches timed with CUDA
    events, cycling through ``args_list`` so the inputs vary per call."""
    import torch
    for args in args_list[:2]:                  # warm up
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, args_list, reps: int = 20) -> float:
    """Median µs the host spends in one call ``fn(*args)``, each call
    issued on an idle card (after a sync) and not waited for."""
    import torch
    ts = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args_list[i % len(args_list)])
        ts.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(ts[2:])


def device_events(run):
    """(name, start µs, duration µs) of every kernel and memset that
    ``run()`` puts on the card, from a torch.profiler (CUPTI) trace; the
    trace ends with a device sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def traced_calls(fn, args_list, reps: int = SPLIT_REPS):
    """``device_events`` of ``reps`` calls ``fn(*args)``, one at a time
    (each call's work ends before the next is issued), after a warm-up."""
    import torch
    fn(*args_list[0])                            # warm up

    def run():
        for i in range(reps):
            fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
    return device_events(run)


def pass_split(fn, args_list, reps: int = SPLIT_REPS):
    """Device µs of a search's two kernels, from ``traced_calls``: the
    median pass 1 (the partial kernel) and pass 2 (the merge kernel), and
    the mean of the rest per search (the int8 wrapper's query
    quantization). None where the trace holds no kernel of that pass."""
    passes = {"pass1_us": [], "pass2_us": [], "other_us": []}
    for name, _, us in traced_calls(fn, args_list, reps):
        key = ("pass2_us" if "merge" in name else
               "pass1_us" if "partial" in name else "other_us")
        passes[key].append(us)
    other = passes["other_us"]
    return {"pass1_us": (statistics.median(passes["pass1_us"])
                         if passes["pass1_us"] else None),
            "pass2_us": (statistics.median(passes["pass2_us"])
                         if passes["pass2_us"] else None),
            "other_us": sum(other) / reps if other else None}


def device_us(fn, args_list, reps: int = SPLIT_REPS, tries: int = TRACE_TRIES):
    """Mean device µs of one call ``fn(*args)``: every kernel and memset it
    runs on the card, from ``traced_calls``. Beside ``cuda_ms`` (CUDA
    events around calls issued back to back) it tells the card's time from
    the host's. A trace may drop the events of a short run: one that
    holds fewer events than calls is taken again, up to ``tries`` times;
    None if none holds them."""
    for _ in range(tries):
        events = traced_calls(fn, args_list, reps)
        if len(events) >= reps:
            return sum(us for _, _, us in events) / reps
    return None


def flushed_kernel_us(cases, name: str, flush, reps: int = SPLIT_REPS,
                      tries: int = TRACE_TRIES):
    """For each ``(fn, args_list)`` of ``cases``, the mean device µs of the
    one kernel whose name holds ``name`` that a call ``fn(*args)``
    launches: ``reps`` calls a case, one at a time, all in one trace (the
    traces of single short runs lose their events), in order. ``flush``,
    a device tensor larger than the L2, is overwritten before each call,
    so every call reads its operands from HBM, as the bound counts them.
    A trace that does not hold one such kernel per call is taken again,
    up to ``tries`` times; all None if none does."""
    import torch
    for fn, args_list in cases:
        fn(*args_list[0])                        # warm up

    def run():
        for fn, args_list in cases:
            for i in range(reps):
                flush.fill_(i)
                fn(*args_list[i % len(args_list)])
                torch.cuda.synchronize()
    for _ in range(tries):
        us = [d for _, d in sorted((start, d) for n, start, d
                                   in device_events(run) if name in n)]
        if len(us) == reps * len(cases):
            return [sum(us[i:i + reps]) / reps
                    for i in range(0, len(us), reps)]
    return [None] * len(cases)


def site_us(events, order, reps: int = SPLIT_REPS):
    """{site shape: mean device µs of its ``conv_s8`` kernels} inside
    ``reps`` traced forwards, by the order the kernels started in:
    ``order`` lists one forward's site shapes in call order. None when the
    trace does not hold one kernel per site."""
    conv = sorted((start, us) for n, start, us in events if "conv_s8" in n)
    if len(conv) != reps * len(order):
        return None
    acc = collections.defaultdict(list)
    for i, (_, us) in enumerate(conv):
        acc[order[i % len(order)]].append(us)
    return {shape: sum(v) / len(v) for shape, v in acc.items()}


def search_bound(n_rows: int, b: int, k: int, dtype: str):
    """Least time (ms) for one search on an H100 SXM and what bounds it:
    the gallery rows the search needs and the queries read once, the
    outputs written once; 2*B*rows*D operations at the dtype's peak (f32:
    F32_TF32_PASSES of them at TF32_PEAK_OPS)."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = n_rows * DIM * item + b * DIM * item + b * k * 8
    ops = 2 * b * n_rows * DIM
    t_ops = (F32_TF32_PASSES * ops / TF32_PEAK_OPS if dtype == "float32"
             else ops / PEAK_OPS[dtype])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mma_ptxas(logs):
    """The ``ptxas -v`` lines of the three instantiations of the searches'
    shared tensor-core pass 1 (``topk_partial_mma_kernel`` in
    ``ops/csrc/topk_mma.cuh``: bf16 and f32 in the cosine_topk build, s8 in
    the cosine_topk_int8 build), by operand type; "not rebuilt" for a
    library that was already built. Fails on a stack frame or a spill in
    any, or on more than MMA_BF16_REGISTERS registers in the bf16 one."""
    out = {}
    # (library, operand type, its mangled template argument)
    for name, typ, mangled in (("cosine_topk", "bf16", "t"),     # uint16_t
                               ("cosine_topk", "f32", "f"),      # float
                               ("cosine_topk_int8", "s8", "a")):  # int8_t
        if name not in logs:
            out[typ] = "not rebuilt"
            continue
        lines, inside = [], False
        for line in logs[name].splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                inside = f"topk_partial_mma_kernelI{mangled}E" in entry[1]
            elif inside and ("stack frame" in line or "Used" in line):
                lines.append(line.strip())
        text = " ".join(lines)
        regs = re.search(r"Used (\d+) registers", text)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", text)
        if regs is None or frame is None:
            raise AssertionError(f"no ptxas -v lines of the {typ} "
                                 f"topk_partial_mma_kernel in {name}'s build")
        out[typ] = {"registers": int(regs[1]), "stack_bytes": int(frame[1]),
                    "spill_bytes": int(frame[2]) + int(frame[3]),
                    "ptxas": lines}
        if out[typ]["stack_bytes"] or out[typ]["spill_bytes"] or (
                typ == "bf16" and out[typ]["registers"] > MMA_BF16_REGISTERS):
            raise AssertionError(f"topk_partial_mma_kernel {typ}: {lines}")
    return out


# the B <= 8 pass 1 kernels by their template arguments' count: those with
# the selection flag (the last argument) set are this file's batched
# selection; the same kernel with the flag clear is k = 1's code
SELECTION_KERNELS = {"topk_partial_kernel": 3,        # <BF16, QT, BATCHED>
                     "topk_int8_partial_kernel": 2}   # <QT, BATCHED>


def ptxas_entries(log, prefix="topk_"):
    """{kernel<template args>: registers, stack and spill bytes} of every
    kernel whose name starts with ``prefix`` (default the search kernels,
    ``topk_*kernel``) in one ``nvcc -Xptxas -v`` log."""
    out, cur = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = None
            # a mangled name is its length, then itself, then "I" and
            # the template arguments ("Lb1E", "Li8E", or a type letter);
            # the length's digits may follow others (a file hash's)
            for m in re.finditer(rf"(\d+)({prefix}\w+)", entry[1]):
                lengths = [int(m[1][i:]) for i in range(len(m[1]))]
                size = next((n for n in lengths
                             if m[2][:n].endswith("kernel")), None)
                if size is None:
                    continue
                ident = m[2][:size]
                rest = m[2][size:]
                t = re.match(r"I((?:L[a-z]\d+E|[a-z])+)E", rest)
                args = [a or b for a, b in re.findall(
                    r"L[a-z](\d+)E|([a-z])", t[1] if t else "")]
                cur = ident + (f"<{','.join(args)}>" if args else "")
                out[cur] = {}
                break
            continue
        if cur is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if regs:
            out[cur]["registers"] = int(regs[1])
        if frame:
            out[cur]["stack_bytes"] = int(frame[1])
            out[cur]["spill_bytes"] = int(frame[2]) + int(frame[3])
    return out


def selection_ptxas(logs):
    """Registers, stack and spill of the B <= 8 pass 1 kernels
    (``topk_partial_kernel``, ``topk_int8_partial_kernel``) at QT in
    {1, 8} and of pass 2 (``topk_merge*kernel``), by library. Fails where a
    kernel with the batched selection has a stack frame and the same kernel
    with k = 1's code (the code all k ran before it) has none, or where a
    pass 2 kernel has one."""
    out = {}
    for name in ("cosine_topk", "cosine_topk_int8"):
        if name not in logs:
            out[name] = "not rebuilt"
            continue
        entries = ptxas_entries(logs[name])
        keep = {}
        for kern, rec in entries.items():
            base, _, args = kern.partition("<")
            args = args.rstrip(">").split(",") if args else []
            if "merge" in base:
                if rec.get("stack_bytes"):
                    raise AssertionError(f"{name} {kern}: {rec}")
                keep[kern] = rec
            elif base in SELECTION_KERNELS and args[-2 if len(args) ==
                                                    SELECTION_KERNELS[base]
                                                    else -1] in ("1", "8"):
                keep[kern] = rec
                if len(args) == SELECTION_KERNELS[base] and args[-1] == "1":
                    twin = f"{base}<{','.join(args[:-1] + ['0'])}>"
                    if rec.get("stack_bytes", 0) and not \
                            entries.get(twin, {}).get("stack_bytes", 0):
                        raise AssertionError(f"{name} {kern} gained a "
                                             f"stack frame: {rec}, {twin}: "
                                             f"{entries.get(twin)}")
        out[name] = keep
    return out


def conv_ptxas(logs):
    """Registers, stack and spill of every kernel of the s8 conv's build
    (``conv_s8_*kernel``); "not rebuilt" where the library was already
    built. Fails on a stack frame or a spill in a tensor-core kernel
    (``conv_s8_mma_kernel``) or a depthwise one (``conv_s8_dw_kernel``),
    or where the depthwise kernel is missing."""
    if "conv_s8" not in logs:
        return "not rebuilt"
    entries = ptxas_entries(logs["conv_s8"], prefix="conv_s8")
    if not entries:
        raise AssertionError("no ptxas -v lines of the conv_s8 kernels")
    if not any("dw" in kern for kern in entries):
        raise AssertionError(f"no conv_s8_dw_kernel in {sorted(entries)}")
    for kern, rec in entries.items():
        if ("mma" in kern or "dw" in kern) and (rec.get("stack_bytes")
                                                or rec.get("spill_bytes")):
            raise AssertionError(f"conv_s8 {kern}: {rec}")
    return entries


def check_search(name, kern, plain_k1, k):
    """Kernel (vals, idx) against the plain version run with k+1: scores
    within SCORE_ATOL; indices equal wherever the plain score at that
    position is more than SCORE_ATOL from its neighbours. Returns the max
    score error."""
    kv, ki = (t.cpu().numpy() for t in kern)
    pv, pi = (t.cpu().numpy() for t in plain_k1)
    err = float(np.abs(kv - pv[:, :k]).max())
    if not np.all(np.isfinite(kv)) or err > SCORE_ATOL:
        raise AssertionError(f"{name}: scores differ by {err}")
    gap = np.full(pv.shape, np.inf)
    gap[:, :-1] = pv[:, :-1] - pv[:, 1:]
    gap[:, 1:] = np.minimum(gap[:, 1:], gap[:, :-1])
    clear = gap[:, :k] > SCORE_ATOL
    bad = clear & (ki != pi[:, :k])
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(f"{name}: index {ki[r, c]} != plain {pi[r, c]} "
                             f"at row {r} position {c}")
    return err


def tie_positions(n, b, device, copies=TIE_COPIES):
    """(b, copies) row indices, ascending along each row: query j's row
    and its copies, one every n // copies rows (so each in its own chunk
    of the B <= 8 plans), offset per query so that no two queries share a
    row."""
    import torch
    step = n // copies
    return (torch.arange(copies, device=device)[None, :] * step
            + torch.arange(b, device=device)[:, None] * 97 + 13)


def check_cutoff_ties(name, vals, idx, pos, k):
    """The top k of a query whose row has more than k copies: the k
    lowest indices of the copies, with bit-equal scores."""
    import torch
    if not (torch.equal(idx.long(), pos[:, :k])
            and torch.equal(vals, vals[:, :1].expand(-1, k))):
        raise AssertionError(f"{name} cutoff ties: got {idx.tolist()}")


def f64_err(g, q, vals, idx):
    """Largest distance of the scores ``vals`` from the f64 dot products of
    ``q`` with the rows ``idx`` of ``g`` that they claim."""
    exact = (q.double()[:, None, :] * g[idx.long()].double()).sum(-1)
    return float((vals.double() - exact).abs().max())


def synthetic_faces(rng, n_ids, hw):
    """``sample(k)``: identity k's base face (uniform in [40, 215)) plus
    N(0, 12) noise, as uint8 BGR crops (tests/test_train_to_serve.py)."""
    base = rng.uniform(40, 215, size=(n_ids, *hw, 3))

    def sample(k):
        return np.clip(base[k] + rng.normal(0, 12, base[k].shape), 0,
                       255).astype(np.uint8)
    return sample


def _train_run(state0, x, labels, network, dtype, remat, steps):
    """``steps`` steps of ``make_train_step`` from ``state0`` on one batch:
    (record, final state, state after the first step)."""
    import torch

    from facekit_torch.train import make_train_step
    step = make_train_step(network, lr=TRAIN_LR, remat=remat,
                           compute_dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, first, losses, events, host = state0, None, [], [], []
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        state, loss = step(state, x, labels)
        ev[1].record()
        host.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        events.append(ev)
        if i == 0:
            first = state
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    # step 0 is the warm-up (cuDNN's algorithm search, first allocations)
    ms = [a.elapsed_time(b) for a, b in events[1:]]
    rec = {"dtype": str(dtype).split(".")[-1], "remat": remat,
           "losses": losses, "step_ms": statistics.median(ms),
           "step_ms_all": ms, "host_issue_ms": statistics.median(host[1:]),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "peak_mem_above_state_bytes":
               torch.cuda.max_memory_allocated() - base}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {rec['dtype']} remat={remat}: "
                             f"losses {losses}")
    if not remat:
        # one more step under torch.profiler: the card's busy ms against
        # the host's, and where the host's time goes
        trace = call_trace(lambda s: step(s, x, labels), state)
        trace["idle_share"] = 1 - trace["device_busy_ms"] / trace["host_ms"]
        rec["trace"] = trace
    return rec, state, first


def phase_train(device, repo_dir, power, seed=16, network="ir_50",
                batch=TRAIN_BATCH, steps=TRAIN_STEPS):
    """The port's training on the card at the full width of IR-50
    (112x112, 512-d): ``train_state_init`` and ``make_train_step`` on one
    fixed batch of ``batch`` synthetic identities, ``steps`` steps in bf16
    and in f32 (TF32 off), each again with ``remat=True``: losses, step
    ms by CUDA events after one warm-up step, peak memory; every leaf's
    gradient non-zero, the masters f32, no kernel launched by a step.
    Then the round trip: ``save_checkpoint`` -> ``python -m
    facekit_torch.weights train-checkpoint`` -> a configs/default.json
    server with that ``rec_weights`` enrolls one sample per identity and
    recognizes held-out ones (accuracy, launches). Last, a server with
    ``rec_outputDim: 256`` (searches at D = 256 through zero padding)."""
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.train import train_state_init
    from facekit_torch.train.checkpoint import (latest_step_dir,
                                                save_checkpoint)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    cfg = load_config(os.path.join(repo_dir, "configs", "default.json"))
    cfg = dataclasses.replace(cfg, rec_network=network)
    hw = tuple(cfg.rec_hw)
    sample = synthetic_faces(rng, batch, hw)
    crops = np.stack([sample(k) for k in range(batch)])
    labels = np.arange(batch, dtype=np.int32)
    # the serving path's normalization (BGR -> RGB, (x - 127.5) / 128)
    x = (crops[..., ::-1].astype(np.float32) - 127.5) * 0.0078125
    t0 = time.perf_counter()
    state0 = train_state_init(batch, network, lr=TRAIN_LR, seed=seed,
                              device=device)
    init_s = time.perf_counter() - t0
    runs, trained = [], None
    reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        for remat in (False, True):
            rec, state, first = _train_run(
                state0, x, labels, network, dtype, remat,
                TRAIN_REMAT_STEPS if remat else steps)
            if not remat:
                zero = [k for k, g in first.momentum["params"].items()
                        if not bool(g.any())]
                if zero or not bool(first.momentum["head"]["w"].any()):
                    raise AssertionError(f"train {rec['dtype']}: leaves "
                                         f"without a gradient: {zero[:8]}")
                if any(v.dtype != torch.float32
                       for v in state.params.values()):
                    raise AssertionError("train: master weights not f32")
                if not rec["losses"][-1] < rec["losses"][0]:
                    raise AssertionError(f"train {rec['dtype']}: loss did "
                                         f"not fall: {rec['losses']}")
                rec["leaves"] = len(first.momentum["params"])
            if dtype == torch.bfloat16 and not remat:
                trained = state
            runs.append(rec)
            del state, first
    counts = launches()
    if any(counts.values()):
        raise AssertionError(f"train steps launched kernels: {counts}")
    by = {(r["dtype"], r["remat"]): r for r in runs}
    bf, f32 = by[("bfloat16", False)], by[("float32", False)]
    rec = {"phase": "train", "network": network, "batch": batch,
           "classes": batch, "lr": TRAIN_LR, "card": power,
           "init_s": init_s, "runs": runs, "launches": counts,
           "bf16_vs_f32_loss": [b - f for b, f in zip(bf["losses"],
                                                      f32["losses"])],
           "bf16_vs_f32_last_loss_rel":
               abs(bf["losses"][-1] - f32["losses"][-1]) /
               abs(f32["losses"][-1]),
           "remat_first_loss_equal": {
               d: by[(d, True)]["losses"][0] == by[(d, False)]["losses"][0]
               for d in ("bfloat16", "float32")}}
    del state0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(root, f"step_{trained.step}"), trained)
        rec["save_checkpoint_s"] = time.perf_counter() - t0
        out = os.path.join(tmp, "trained.msgpack")
        cli_s, verify = _convert_cli(
            repo_dir, device, "train-checkpoint", latest_step_dir(root), out,
            ("--network", network, "--num-classes", str(batch)))
        rec["train_checkpoint_cli"] = {"seconds": cli_s, "verify": verify}
        del trained
        rec["round_trip"] = _served_accuracy(
            dataclasses.replace(cfg, rec_weights=out), tmp, sample, batch,
            device)
    rec["server_dim256"] = _server_dim256(cfg, device, seed)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def _served_accuracy(cfg, tmp, sample, n_ids, device):
    """A server of ``cfg`` enrolls a fresh sample of each identity and
    recognizes TRAIN_QUERIES more of each through ``recognize_batch`` at
    the top bucket: accuracy, similarity and each kernel's launches."""
    import torch

    from facekit_torch.server import FaceServer
    cfg = dataclasses.replace(cfg, database_path=os.path.join(tmp, "t.db"))
    server = FaceServer(cfg, device=device)
    try:
        reset_launches()
        for k in range(n_ids):
            uid = f"id{k:03d}"
            server.db.insert_user(uid, uid)
            emb = server.pipeline.embed_cropped(sample(k))
            if server.db.insert_face(uid, f"{uid}.jpg", emb) != 1:
                raise AssertionError(f"insert_face failed for {uid}")
        server.reload_gallery()
        queries = [sample(k) for k in range(n_ids)
                   for _ in range(TRAIN_QUERIES)]
        top = max(server.batch_buckets)
        answers = []
        for i in range(0, len(queries), top):
            answers += server.recognize_batch(queries[i:i + top])
        torch.cuda.synchronize()
        counts = launches()
    finally:
        server.close()
    want = [f"id{k:03d}" for k in range(n_ids) for _ in range(TRAIN_QUERIES)]
    acc = float(np.mean([a["userId"] == w for a, w in zip(answers, want)]))
    batches = -(-len(queries) // top)
    forwards = n_ids + batches
    if counts["ir_block"] != IR_BLOCKS_PER_FORWARD * forwards or \
            counts["cosine_topk"] != batches or acc < 0.75:
        raise AssertionError(f"round trip: accuracy {acc}, launches "
                             f"{counts} ({forwards} forwards, {batches} "
                             "searches)")
    return {"identities": n_ids, "queries": len(queries), "accuracy": acc,
            "median_similarity": statistics.median(
                a["similarity"] for a in answers),
            "forwards": forwards, "launches": counts}


def _server_dim256(cfg, device, seed, n_users=6):
    """configs/default.json with ``rec_outputDim: 256`` and a 256-wide
    IR-50: enrolls ``n_users`` crops and answers ``recognize_batch`` as
    the plain search on the unpadded rows does."""
    import torch

    from facekit_torch.ops.similarity import cosine_topk_reference
    from facekit_torch.server import FaceServer
    from facekit_torch.weights import random_arcface_params

    rng = np.random.default_rng(seed + 1)
    rh, rw = cfg.rec_hw
    # the enrolled crops and two fresh ones: one batch of the top bucket
    crops = rng.integers(0, 256, (n_users + 2, rh, rw, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, rec_outputDim=256, database_path=(
            os.path.join(tmp, "d256.db")))
        server = FaceServer(cfg, rec_params=random_arcface_params(
            cfg.rec_network, seed=seed, embed_dim=256), device=device)
        try:
            reset_launches()
            for u in range(n_users):
                server.db.insert_user(f"u{u}", f"u{u}")
                server.db.insert_face(f"u{u}", f"u{u}.jpg",
                                      server.pipeline.embed_cropped(crops[u]))
            server.reload_gallery()
            answers = server.recognize_batch(list(crops))
            torch.cuda.synchronize()
            counts = launches()
            snap = server.gallery.snapshot()
            emb, vals, idx = server.serving_embed(
                server.pad_batch(list(crops)), snap)
            plain_v, plain_i = cosine_topk_reference(
                snap.arr[:, :256].contiguous(), emb.to(snap.arr.dtype),
                snap.count, 1)
        finally:
            server.close()
    names = [a["userId"] for a in answers]
    err = float((vals[:, 0] - plain_v[:, 0]).abs().max())
    if tuple(snap.arr.shape[1:]) != (DIM,) or emb.shape[1] != 256 or \
            not torch.equal(idx[:, 0], plain_i[:, 0]) or err > SCORE_ATOL or \
            names[:n_users] != [f"u{u}" for u in range(n_users)] or \
            counts["cosine_topk"] != 1:
        raise AssertionError(f"rec_outputDim 256 server: {names}, "
                             f"launches {counts}, err {err}")
    return {"embed_dim": 256, "device_row_width": int(snap.arr.shape[1]),
            "users": n_users, "requests": len(crops), "launches": counts,
            "max_abs_err": err,
            "min_enrolled_similarity": float(vals[:n_users, 0].min())}


def phase_kernels(device, n=N_TOP, seed=0):
    """The search kernel against its plain version at N rows: timed at B in
    {1, 8, 32, 256} (B > 8 runs the tensor-core pass 1: 3xTF32 in f32),
    k in {1, 64}, each split into pass 1 and pass 2 (``pass_split``);
    ties, ties at the k = 64 cutoff, k > count and the query tiles the
    timed batches miss checked."""
    import torch

    from facekit_torch.ops.similarity import (cosine_topk,
                                              cosine_topk_reference)
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit_rows(rows, dtype):
        x = torch.randn((rows, DIM), generator=gen, device=device)
        return (x / x.norm(dim=1, keepdim=True)).to(dtype)

    g32 = unit_rows(n, torch.float32)
    galleries = {"bfloat16": g32.to(torch.bfloat16), "float32": g32}
    count = n - 37
    max_err, timings = 0.0, []
    for dname, g in galleries.items():
        for b in (1, 8, 32, 256):
            for k in (1, 64):
                qs = [unit_rows(b, g.dtype) for _ in range(4)]
                tag = f"{dname} B={b} k={k}"
                kern = cosine_topk(g, qs[0], count, k)
                err = check_search(tag, kern,
                                   cosine_topk_reference(g, qs[0], count,
                                                         k + 1), k)
                lib = torch.topk(qs[0] @ g[:count].T, k)
                max_err = max(max_err, err)
                args = [(g, q, count, k) for q in qs]
                bound, by = search_bound(min(n, count + k), b, k, dname)
                rec = {"phase": "kernel_case", "dtype": dname, "N": n,
                       "count": count, "B": b, "k": k, "max_abs_err": err,
                       # score error against f64 at the rows returned
                       "err_vs_f64": f64_err(g, qs[0], *kern),
                       "library_err_vs_f64": f64_err(g, qs[0], *lib),
                       "ms": cuda_ms(cosine_topk, args, 20),
                       "plain_ms": cuda_ms(cosine_topk_reference, args, 3),
                       "library_ms": cuda_ms(
                           lambda g_, q_, c_, k_: torch.topk(q_ @ g_[:c_].T,
                                                             k_),
                           args, 10),
                       "bound_ms": bound, "bound_by": by,
                       **pass_split(cosine_topk, args)}
                emit(rec)
                timings.append(rec)

        # cutoff ties: query j's row has TIE_COPIES copies, each in its
        # own chunk; the top 64 must be the 64 lowest of them, bit-equal
        for b in (1, 8):
            pos = tie_positions(n, b, device)
            gt = g.clone()
            gt[pos.reshape(-1)] = gt[pos[:, :1].expand(-1, TIE_COPIES)
                                     .reshape(-1)]
            check_cutoff_ties(f"{dname} B={b}",
                              *cosine_topk(gt, gt[pos[:, 0]].contiguous(),
                                           n, 64), pos, 64)
            del gt

        # the query tiles the timed batches do not reach: 2 and 4 queries
        # of the CUDA-core kernel; of the tensor-core kernel one m16 tile
        # (9, 16), a full 64-query tile, and in f32 (32 queries a CTA) a
        # second tile with one query (33) and in part (40)
        for b in (2, 3, 9, 16, 33, 40, 64):
            q = unit_rows(b, g.dtype)
            max_err = max(max_err, check_search(
                f"{dname} B={b} k=5", cosine_topk(g, q, count, 5),
                cosine_topk_reference(g, q, count, 6), 5))

        # ties: row j duplicates row i < j and the query is that row, so
        # the two equal top scores must come back lower index first; the
        # two rows sit in different chunks and, +5, at different places of
        # their 128-row tiles; at 33 the queries span two f32 query tiles
        for b in (8, 16, 33):
            lo = torch.arange(b, device=device) * (n // (2 * b)) + 17
            hi = lo + n // 2 + 5
            gt = g.clone()
            gt[hi] = gt[lo]
            v, i = cosine_topk(gt, gt[lo].contiguous(), n, 2)
            i = i.cpu().numpy()
            if not (np.array_equal(i[:, 0], lo.cpu().numpy())
                    and np.array_equal(i[:, 1], hi.cpu().numpy())
                    and torch.equal(v[:, 0], v[:, 1])):
                raise AssertionError(f"{dname} B={b} ties: got {i.tolist()}")
            del gt

        # k > count: the masked padding rows follow in ascending order
        for b in (8, 33):
            q = unit_rows(b, g.dtype)
            kern = cosine_topk(g, q, 3, 8)
            max_err = max(max_err, check_search(
                f"{dname} B={b} k>count", kern,
                cosine_topk_reference(g, q, 3, 9), 8))
            if not np.array_equal(np.sort(kern[1].cpu().numpy()[:, :3], 1),
                                  np.tile(np.arange(3), (b, 1))) or \
                    not np.array_equal(kern[1].cpu().numpy()[:, 3:],
                                       np.tile(np.arange(3, 8), (b, 1))):
                raise AssertionError(f"{dname} B={b} k>count: "
                                     f"{kern[1].tolist()}")
    torch.cuda.synchronize()
    return max_err, timings


def phase_server(device, repo_dir, seed=1, n_users=32):
    """configs/default.json's /recognize + enrollment path on the card."""
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.ops.similarity import cosine_topk_reference
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.server import FaceServer
    from facekit_torch.weights import random_arcface_params

    rng = np.random.default_rng(seed)
    cfg = load_config(os.path.join(repo_dir, "configs", "default.json"))
    params = random_arcface_params(cfg.rec_network, seed=seed)
    rh, rw = cfg.rec_hw
    crops = rng.integers(0, 256, (n_users, rh, rw, 3), dtype=np.uint8)
    fresh = rng.integers(0, 256, (4, rh, rw, 3), dtype=np.uint8)
    enrolled_q = [0, 5, 10, n_users - 1]
    queries = np.concatenate([crops[enrolled_q], fresh])       # 8 requests
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, database_path=os.path.join(
            tmp, "facekit.db"))
        server = FaceServer(cfg, rec_params=params, device=device)
        try:
            reset_launches()
            # -- the main path: enrollment as /insert/face makes it, then
            #    /recognize through the micro-batcher's function
            for u in range(n_users):
                uid = f"user{u:02d}"
                server.db.insert_user(uid, f"User {u}")
                emb = server.pipeline.embed_cropped(crops[u])
                if server.db.insert_face(uid, f"crop{u}.jpg", emb) != 1:
                    raise AssertionError(f"insert_face failed for {uid}")
            server.reload_gallery()
            answers = [server.recognize_batch([queries[0]]),
                       server.recognize_batch(list(queries))]
            torch.cuda.synchronize()
            counts = launches()
            forwards = n_users + 2
            if counts["cosine_topk"] < 2 or counts["cosine_topk_int8"] or \
                    counts["conv_s8"] or \
                    counts["ir_block"] != IR_BLOCKS_PER_FORWARD * forwards:
                raise AssertionError(f"launches on the /recognize path of "
                                     f"configs/default.json ({forwards} "
                                     f"forwards): {counts}")

            # -- checks
            snap = server.gallery.snapshot()
            emb, vals, idx = server.serving_embed(server.pad_batch(
                list(queries)), snap)
            names = [snap.names[int(i)] for i in idx[:8, 0].cpu()]
            if [a["userId"] for a in answers[1]] != names or \
                    answers[0][0]["userId"] != names[0]:
                raise AssertionError(f"recognize_batch {answers} != "
                                     f"serving_embed {names}")
            plain = cosine_topk_reference(
                snap.arr, emb.to(snap.arr.dtype), snap.count, 2)
            err = check_search("server search", (vals, idx), plain, 1)
            if list(plain[1][:8, 0].cpu().numpy()) != \
                    list(idx[:8, 0].cpu().numpy()):
                raise AssertionError("userIds differ from the plain search")
            sims = vals[:8, 0].cpu().numpy()
            for j, u in enumerate(enrolled_q):
                if names[j] != f"user{u:02d}" or sims[j] < 0.99:
                    raise AssertionError(f"enrolled crop {u}: got {names[j]} "
                                         f"at similarity {sims[j]}")
            cpu_cfg = dataclasses.replace(cfg, compute_dtype="float32")
            e_cpu = FacePipeline(cpu_cfg, params, device="cpu") \
                .embed_cropped_batch(queries)
            e_gpu = emb[:8].cpu().numpy()
            if not np.all(np.isfinite(e_gpu)) or e_gpu.shape != (8, DIM):
                raise AssertionError("embeddings not finite (8, 512)")
            cos_dist = float((1 - (e_cpu * e_gpu).sum(-1)).max())
            if cos_dist > COS_DIST_MAX:
                raise AssertionError(f"bf16 card vs f32 CPU embeddings: "
                                     f"cosine distance {cos_dist}")

            # -- embed+match latency at each batch bucket, with the fused
            #    blocks and (a guide) with the blocks op by op, in turns
            def embed_match_ms(b, reps=12):
                ts = []
                for r in range(reps):
                    batch = rng.integers(0, 256, (b, rh, rw, 3), np.uint8)
                    t0 = time.perf_counter()
                    _, v, _ = server.serving_embed(server.pad_batch(
                        list(batch)), snap)
                    v.cpu()
                    ts.append((time.perf_counter() - t0) * 1e3)
                return ts[2:]
            lat = {}
            for _ in range(2):
                for b in (1, 8):
                    lat.setdefault(f"embed_match_ms_b{b}", []).extend(
                        embed_match_ms(b))
                    with composed_blocks():
                        lat.setdefault(f"embed_match_ms_b{b}_composed",
                                       []).extend(embed_match_ms(b))
            rec = {"phase": "server", "config": "configs/default.json",
                   "network": cfg.rec_network, "dtype": cfg.compute_dtype,
                   "users": n_users, "requests": len(queries),
                   "gallery_capacity": server.gallery.capacity,
                   "forwards": forwards, "launches": counts,
                   "max_abs_err": err, "cos_dist_vs_f32_cpu": cos_dist,
                   "min_enrolled_similarity": float(sims[:4].min()),
                   **{k: statistics.median(v) for k, v in lat.items()}}
            emit(rec)
            return rec
        finally:
            server.close()


def int8_search_bound(n_rows: int, b: int, k: int):
    """Least time (ms) for one int8 search on an H100 SXM and what bounds
    it: the int8 rows the search needs and their f32 scales, the f32
    queries read once, the outputs written once; 2*B*rows*D operations at
    the int8 tensor-core rate."""
    nbytes = n_rows * (DIM + 4) + b * DIM * 4 + b * k * 8
    ops = 2 * b * n_rows * DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["int8"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_library_call(gq, gs, count, k):
    """The library yardstick for the int8 search: ``torch._int_mm`` of the
    quantized queries (padded to at least 32 rows, as it takes more than
    16) and the gallery, scaled, then ``torch.topk``. Returns (fn of the
    f32 queries, what is timed, why ``_int_mm(q, g[:count].T)`` itself was
    refused or None)."""
    import torch

    from facekit_torch.ops.similarity import NEG_INF, quantize_rows_int8

    def prep(q):
        qq, qs = quantize_rows_int8(q)
        pad = max(32, -(-qq.shape[0] // 8) * 8) - qq.shape[0]
        return torch.nn.functional.pad(qq, (0, 0, 0, pad)), qs

    def exact(q):
        qq, qs = prep(q)
        acc = torch._int_mm(qq, gq[:count].T)[:q.shape[0]]
        return torch.topk((acc.float() * qs[:, None]) * gs[None, :count], k)

    def masked(q):
        qq, qs = prep(q)
        acc = torch._int_mm(qq, gq.T)[:q.shape[0]]
        s = (acc.float() * qs[:, None]) * gs[None, :]
        s[:, count:] = NEG_INF
        return torch.topk(s, k)

    try:
        exact(torch.zeros((1, DIM), device=gq.device))
        return exact, "_int_mm(q, g[:count].T) + topk", None
    except RuntimeError as e:
        return (masked, "_int_mm(q, g.T) over all N rows, masked + topk",
                str(e).splitlines()[0])


def phase_int8_kernels(device, n=N_TOP, seed=2):
    """The int8 search kernel against its plain version at N rows: scores
    bit for bit, indices equal. Timed at B in {1, 8, 64, 256} (B > 8 runs
    the tensor-core pass 1), k in {1, 64}, each split into pass 1 and pass
    2 (``pass_split``); ties, ties at the k = 64 cutoff, k > count and the
    query tiles the timed batches miss checked."""
    import torch

    from facekit_torch.ops.similarity import (cosine_topk_int8,
                                              cosine_topk_int8_reference,
                                              quantize_rows_int8)
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit_rows(rows):
        x = torch.randn((rows, DIM), generator=gen, device=device)
        return x / x.norm(dim=1, keepdim=True)

    g32 = unit_rows(n)
    gq, gs = quantize_rows_int8(g32)
    count = n - 37

    def check(tag, kern, plain):
        if not (torch.equal(kern[0], plain[0])
                and torch.equal(kern[1], plain[1])):
            raise AssertionError(f"int8 {tag}: kernel differs from the plain "
                                 "version")

    timings = []
    for b in (1, 8, 64, 256):
        for k in (1, 64):
            qs = [unit_rows(b) for _ in range(4)]
            check(f"B={b} k={k}", cosine_topk_int8(gq, gs, qs[0], count, k),
                  cosine_topk_int8_reference(gq, gs, qs[0], count, k))
            args = [(gq, gs, q, count, k) for q in qs]
            bound, by = int8_search_bound(min(n, count + k), b, k)
            lib_fn, lib_what, lib_refused = int8_library_call(gq, gs, count,
                                                              k)
            rec = {"phase": "kernel_int8_case", "N": n, "count": count,
                   "B": b, "k": k, "max_abs_err": 0.0,
                   "ms": cuda_ms(cosine_topk_int8, args, 20),
                   "plain_ms": cuda_ms(cosine_topk_int8_reference, args, 3),
                   "library_ms": cuda_ms(
                       lambda g_, s_, q_, c_, k_: lib_fn(q_), args, 10),
                   "library_call": lib_what, "library_refused": lib_refused,
                   "bound_ms": bound, "bound_by": by,
                   **pass_split(cosine_topk_int8, args)}
            emit(rec)
            timings.append(rec)

    # cutoff ties: query j's row has TIE_COPIES copies, each in its own
    # chunk; the top 64 must be the 64 lowest of them, bit-equal
    for b in (1, 8):
        pos = tie_positions(n, b, device)
        src = pos[:, :1].expand(-1, TIE_COPIES).reshape(-1)
        gqt, gst = gq.clone(), gs.clone()
        gqt[pos.reshape(-1)], gst[pos.reshape(-1)] = gqt[src], gst[src]
        q = g32[pos[:, 0]].contiguous()
        kern = cosine_topk_int8(gqt, gst, q, n, 64)
        check(f"B={b} cutoff ties", kern,
              cosine_topk_int8_reference(gqt, gst, q, n, 64))
        check_cutoff_ties(f"int8 B={b}", *kern, pos, 64)
        del gqt, gst

    # the query tiles the timed batches do not reach: 2 and 4 queries of
    # the CUDA-core kernel; in the tensor-core kernel one m16 tile (9), a
    # full m16 pair (16), and queries 0-31 on warps 0-3 with one query in
    # the first m16 tile of warps 4-7 (33)
    for b in (2, 3, 9, 16, 33):
        q = unit_rows(b)
        check(f"B={b} k=5", cosine_topk_int8(gq, gs, q, count, 5),
              cosine_topk_int8_reference(gq, gs, q, count, 5))

    # ties: row j duplicates row i < j and the query is that row, so the
    # two equal top scores must come back lower index first; the two rows
    # sit in different chunks and, +5, at different places of their
    # 128-row tiles
    for b in (8, 16, 64):
        lo = torch.arange(b, device=device) * (n // (2 * b)) + 17
        hi = lo + n // 2 + 5
        gqt, gst = gq.clone(), gs.clone()
        gqt[hi], gst[hi] = gqt[lo], gst[lo]
        q = g32[lo].contiguous()
        v, i = cosine_topk_int8(gqt, gst, q, n, 2)
        check(f"B={b} ties", (v, i),
              cosine_topk_int8_reference(gqt, gst, q, n, 2))
        i = i.cpu().numpy()
        if not (np.array_equal(i[:, 0], lo.cpu().numpy())
                and np.array_equal(i[:, 1], hi.cpu().numpy())
                and torch.equal(v[:, 0], v[:, 1])):
            raise AssertionError(f"int8 B={b} ties: got {i.tolist()}")
        del gqt, gst

    # k > count: the masked padding rows follow in ascending order
    for b in (8, 33):
        q = unit_rows(b)
        kern = cosine_topk_int8(gq, gs, q, 3, 8)
        check(f"B={b} k>count", kern,
              cosine_topk_int8_reference(gq, gs, q, 3, 8))
        if not np.array_equal(kern[1].cpu().numpy()[:, 3:],
                              np.tile(np.arange(3, 8), (b, 1))):
            raise AssertionError(f"int8 B={b} k>count: {kern[1].tolist()}")
    torch.cuda.synchronize()
    return timings


def phase_big_batches(device, n=N_TOP, seed=7):
    """Both searches past 256 queries (B in BIG_BATCHES, k in {1, 64}) at
    the top gallery bucket against their plain versions: bf16 and f32
    scores within SCORE_ATOL and indices equal wherever the plain scores
    are more than SCORE_ATOL apart (``check_search``), int8 scores and
    indices bit for bit; each timed beside its bound."""
    import torch

    from facekit_torch.ops.similarity import (cosine_topk,
                                              cosine_topk_int8,
                                              cosine_topk_int8_reference,
                                              cosine_topk_reference,
                                              quantize_rows_int8)
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit_rows(rows):
        x = torch.randn((rows, DIM), generator=gen, device=device)
        return x / x.norm(dim=1, keepdim=True)

    g32 = unit_rows(n)
    gq, gs = quantize_rows_int8(g32)
    count = n - 37
    out = []
    for dname in ("bfloat16", "float32", "int8"):
        for b in BIG_BATCHES:
            for k in (1, 64):
                q = unit_rows(b)
                tag = f"{dname} B={b} k={k}"
                if dname == "int8":
                    args = (gq, gs, q, count, k)
                    kern = cosine_topk_int8(*args)
                    plain = cosine_topk_int8_reference(*args)
                    if not (torch.equal(kern[0], plain[0])
                            and torch.equal(kern[1], plain[1])):
                        raise AssertionError(f"{tag}: kernel differs from "
                                             "the plain version")
                    err = 0.0
                    fn, bound = cosine_topk_int8, int8_search_bound(
                        min(n, count + k), b, k)
                else:
                    g = g32.to(getattr(torch, dname))
                    args = (g, q.to(g.dtype), count, k)
                    err = check_search(tag, cosine_topk(*args),
                                       cosine_topk_reference(
                                           *args[:3], k + 1), k)
                    fn, bound = cosine_topk, search_bound(
                        min(n, count + k), b, k, dname)
                rec = {"phase": "big_batch_case", "dtype": dname, "N": n,
                       "count": count, "B": b, "k": k, "max_abs_err": err,
                       "ms": cuda_ms(fn, [args], 5),
                       "bound_ms": bound[0], "bound_by": bound[1]}
                emit(rec)
                out.append(rec)
    torch.cuda.synchronize()
    return out


def ir50_conv_shapes(batch: int):
    """{(N, H, W, C, O, k, stride, pad): [site names]} of the int8 IR-50's
    52 conv sites at ``batch``, in the order a forward meets them."""
    from facekit_torch.models.arcface import block_specs
    shapes = {}
    h = 112
    shapes.setdefault((batch, h, h, 3, 64, 3, 1, 1), []).append("input")
    for i, (in_c, depth, stride) in enumerate(block_specs("ir_50")):
        shapes.setdefault((batch, h, h, in_c, depth, 3, 1, 1),
                          []).append(f"b{i}.conv1")
        shapes.setdefault((batch, h, h, depth, depth, 3, stride, 1),
                          []).append(f"b{i}.conv2")
        if in_c != depth:
            shapes.setdefault((batch, h, h, in_c, depth, 1, stride, 0),
                              []).append(f"b{i}.shortcut")
        h = (h - 1) // stride + 1
    if sum(len(v) for v in shapes.values()) != SITES_PER_FORWARD:
        raise AssertionError("IR-50 does not have 52 conv sites")
    return shapes


def conv_bound(n, h, w, c, o, ks, stride, pad, groups=1):
    """Least time (ms) of one s8 conv on an H100 SXM and what bounds it:
    x and w read once, the int32 output written once; 2*M*O*K operations
    (K = ks*ks*C / groups) at the int8 tensor-core rate."""
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    k = ks * ks * c // groups
    nbytes = n * h * w * c + o * k + 4 * n * oh * ow * o
    ops = 2 * n * oh * ow * o * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["int8"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_conv(device, batches=CONV_BATCHES, seed=3):
    """The s8 conv kernel against its plain version (bit for bit) at every
    conv shape of the int8 IR-50 at each of ``batches`` and at the TPU
    kernel's own shape, each with the route the wrapper takes there
    (``conv_route``: ``mma`` tensor cores or ``dp4a``) and its plan
    (``_conv_plan``); cuDNN's bf16 conv of the same shape timed beside it
    as a yardstick only (another function, which the port does not
    call)."""
    import torch
    import torch.nn.functional as F

    from facekit_torch.ops.conv_s8 import (_launch_plan, conv_route, conv_s8,
                                           conv_s8_reference)
    gen = torch.Generator(device=device).manual_seed(seed)
    cases = [(shape, batch, len(sites), ",".join(sites[:3])
              + (",..." if len(sites) > 3 else ""))
             for batch in batches
             for shape, sites in ir50_conv_shapes(batch).items()]
    cases.append((KERNEL4_SHAPE, KERNEL4_SHAPE[0], 0,
                  "kernel #4 (conv_s8_s2_pallas)"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = []
    for (n, h, w, c, o, ks, stride, pad), batch, per_forward, sites in cases:
        xs = [torch.randint(-127, 128, (n, h, w, c), generator=gen,
                            device=device, dtype=torch.int8)
              for _ in range(2)]
        wt = torch.randint(-127, 128, (o, ks, ks, c), generator=gen,
                           device=device, dtype=torch.int8)
        got = conv_s8(xs[0], wt, stride, pad)
        ref = conv_s8_reference(xs[0], wt, stride, pad)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"conv_s8 {(n, h, w, c, o, ks, stride, pad)}: "
                f"{int((got != ref).sum())} outputs differ from the plain "
                "version")
        del got, ref
        args = [(x, wt, stride, pad) for x in xs]
        xb = [x.permute(0, 3, 1, 2).to(torch.bfloat16) for x in xs]
        wb = wt.permute(0, 3, 1, 2).to(torch.bfloat16)
        bound, by = conv_bound(n, h, w, c, o, ks, stride, pad)
        oh = (h + 2 * pad - ks) // stride + 1
        ow = (w + 2 * pad - ks) // stride + 1
        route = conv_route(c)
        plan = _launch_plan(n, oh, ow, o, c, ks, sms)
        rec = {"phase": "conv_s8_case", "batch": batch,
               "shape": {"N": n, "H": h, "W": w, "C": c, "O": o, "k": ks,
                         "stride": stride, "pad": pad},
               "sites": sites, "launches_per_forward": per_forward,
               "route": route,
               "plan": plan._asdict() if plan.bn else None,
               "max_abs_err": 0,
               "ms": cuda_ms(conv_s8, args, 20),
               "host_us": host_us(conv_s8, args),
               "device_us": device_us(conv_s8, args),
               "plain_ms": cuda_ms(conv_s8_reference, args, 2),
               "bf16_cudnn_ms": cuda_ms(
                   lambda x_, w_: F.conv2d(x_, w_, stride=stride,
                                           padding=pad),
                   [(x, wb) for x in xb], 20),
               "bf16_cudnn_device_us": device_us(
                   lambda x_, w_: F.conv2d(x_, w_, stride=stride,
                                           padding=pad),
                   [(x, wb) for x in xb]),
               "library_ms": None,
               "bound_ms": bound, "bound_by": by}
        emit(rec)
        out.append(rec)
        del xs, xb
    torch.cuda.synchronize()
    return out


def _ms(us):
    return None if us is None else us / 1e3


def conv_forwards(convs):
    """One line per batch of ``convs``: the conv_s8_case lines of the int8
    IR-50's sites summed by their launches_per_forward (ms, host ms,
    device ms, bound, plain version, bf16 cuDNN yardstick), and the sites
    each route serves."""
    out = []
    for batch in sorted({c["batch"] for c in convs
                         if c["launches_per_forward"]}):
        cs = [c for c in convs
              if c["batch"] == batch and c["launches_per_forward"]]

        def total(key, cs=cs):
            if any(c[key] is None for c in cs):
                return None              # a case whose trace held no kernel
            return sum(c[key] * c["launches_per_forward"] for c in cs)
        routes = {}
        for c in cs:
            routes[c["route"]] = (routes.get(c["route"], 0)
                                  + c["launches_per_forward"])
        rec = {"phase": "conv_s8_forward", "batch": batch,
               "launches_per_forward": sum(c["launches_per_forward"]
                                           for c in cs),
               "ms": total("ms"), "host_ms": total("host_us") / 1e3,
               "device_ms": _ms(total("device_us")),
               "bound_ms": total("bound_ms"),
               "plain_ms": total("plain_ms"),
               "bf16_cudnn_ms": total("bf16_cudnn_ms"),
               "bf16_cudnn_device_ms": _ms(total("bf16_cudnn_device_us")),
               "sites_by_route": routes}
        if rec["launches_per_forward"] != SITES_PER_FORWARD:
            raise AssertionError(f"conv_s8 batch {batch}: "
                                 f"{rec['launches_per_forward']} sites")
        emit(rec)
        out.append(rec)
    return out


def phase_int8_forward(device, repo_dir, batches=CONV_BATCHES, seed=4,
                       reps=FORWARD_REPS):
    """The embedder of configs/throughput.json (int8 IR-50, dynamic
    activation scales, random weights), the forward /recognize runs, at
    each of ``batches``: ms to issue one forward on the host and to its
    end (median of ``reps``, each after a sync), ms per forward by CUDA
    events around ``reps`` forwards issued back to back, and from a trace
    of ``reps`` back-to-back forwards, per forward: the device operations
    (conv_s8 kernels and memsets among them), the ms the card was busy
    (conv_s8's share) and the idle share of the back-to-back time. The
    trace's counts are reported, not checked: a trace may drop a few
    events (one run lost 52 of 14,700); the launch counters are the
    check."""
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.ops.preprocess import rec_normalize
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.weights import random_arcface_params

    cfg = load_config(os.path.join(repo_dir, "configs", "throughput.json"))
    pipe = FacePipeline(cfg, random_arcface_params(cfg.rec_network,
                                                   seed=seed), device=device)
    net = pipe.rec_net
    if net.int8 != "dynamic":
        raise AssertionError(f"int8_forward: the embedder is {net.int8}")
    rh, rw = cfg.rec_hw
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        xs = [rec_normalize(torch.tensor(
            rng.integers(0, 256, (b, rh, rw, 3), dtype=np.uint8),
            device=device).float()) for _ in range(2)]
        with torch.inference_mode():
            issue, end = [], []
            for i in range(reps + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net(xs[i % 2])
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                issue.append((t1 - t0) * 1e3)
                end.append((time.perf_counter() - t0) * 1e3)
            ms = cuda_ms(net, [(x,) for x in xs], reps)
            events = device_events(
                lambda: [net(xs[i % 2]) for i in range(reps)])
        busy = sum(us for _, _, us in events) / reps / 1e3
        conv = [us for name, _, us in events if "conv_s8" in name]
        rec = {"phase": "int8_forward", "batch": b, "scales": "dynamic",
               "reps": reps,
               "host_issue_ms": statistics.median(issue[2:]),
               "issue_to_end_ms": statistics.median(end[2:]),
               "back_to_back_ms": ms,
               "device_ops_per_forward": len(events) / reps,
               "conv_s8_kernels_per_forward": len(conv) / reps,
               "memsets_per_forward": sum("emset" in name
                                          for name, _, _ in events) / reps,
               "device_busy_ms": busy,
               "conv_s8_device_ms": sum(conv) / reps / 1e3,
               "idle_share": max(0.0, 1 - busy / ms)}
        emit(rec)
        out.append(rec)
    return out


def phase_server_throughput(device, repo_dir, seed=4, n_users=32):
    """configs/throughput.json's /recognize + enrollment path on the card:
    the int8 IR-50 (every conv through conv_s8) and the int8 gallery
    (cosine_topk_int8), batches of 1, 8 and 64 crops; with dynamic
    activation scales (no calibration folder), then with scales
    calibrated from a folder of crops."""
    import cv2

    from facekit_torch.config import load_config
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.server import FaceServer
    from facekit_torch.weights import random_arcface_params

    rng = np.random.default_rng(seed)
    cfg = load_config(os.path.join(repo_dir, "configs", "throughput.json"))
    params = random_arcface_params(cfg.rec_network, seed=seed)
    rh, rw = cfg.rec_hw
    crops = rng.integers(0, 256, (n_users, rh, rw, 3), dtype=np.uint8)
    fresh = rng.integers(0, 256, (64, rh, rw, 3), dtype=np.uint8)
    enrolled_q = [0, 5, 10, n_users - 1]
    # requests of 1, 8 and 64 crops, each led by enrolled crops
    batches = [crops[:1],
               np.concatenate([crops[enrolled_q], fresh[:4]]),
               np.concatenate([crops[enrolled_q], fresh[:60]])]
    e_cpu = FacePipeline(dataclasses.replace(
        cfg, rec_quantize=False, compute_dtype="float32"), params,
        device="cpu").embed_cropped_batch(batches[1])
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        calib_dir = os.path.join(tmp, "crops")
        os.mkdir(calib_dir)
        for i, c in enumerate(crops[:16]):
            cv2.imwrite(os.path.join(calib_dir, f"c{i:02d}.png"), c)
        for mode in ("dynamic", "calibrated"):
            extras = dict(cfg.extras)
            extras.pop("rec_calibrationDir", None)
            if mode == "calibrated":
                extras["rec_calibrationDir"] = calib_dir
            run_cfg = dataclasses.replace(
                cfg, extras=extras,
                database_path=os.path.join(tmp, f"{mode}.db"))
            server = FaceServer(run_cfg, rec_params=params, device=device)
            try:
                results.append(_throughput_run(
                    server, mode, crops, batches, enrolled_q, e_cpu, rng))
            finally:
                server.close()
    return results


def _throughput_run(server, mode, crops, batches, enrolled_q, e_cpu, rng):
    import torch

    from facekit_torch.ops.preprocess import rec_normalize
    from facekit_torch.ops.similarity import cosine_topk_int8_reference

    want = "static" if mode == "calibrated" else "dynamic"
    if server.pipeline.rec_net.int8 != want:
        raise AssertionError(f"{mode}: the embedder is "
                             f"{server.pipeline.rec_net.int8}")
    rh, rw = server.config.rec_hw
    n_users = len(crops)
    reset_launches()
    # -- the main path: enrollment as /insert/face makes it, then
    #    /recognize through the micro-batcher's function at 1, 8, 64 crops
    for u in range(n_users):
        uid = f"user{u:02d}"
        server.db.insert_user(uid, f"User {u}")
        emb = server.pipeline.embed_cropped(crops[u])
        if server.db.insert_face(uid, f"crop{u}.jpg", emb) != 1:
            raise AssertionError(f"insert_face failed for {uid}")
    server.reload_gallery()
    answers = [server.recognize_batch(list(b)) for b in batches]
    torch.cuda.synchronize()
    counts = launches()
    forwards = n_users + len(batches)
    if counts["conv_s8"] != SITES_PER_FORWARD * forwards or \
            counts["cosine_topk_int8"] < len(batches) or \
            counts["cosine_topk"] or counts["ir_block"]:
        raise AssertionError(f"{mode}: launches {counts} on the throughput "
                             f"path ({forwards} forwards, {len(batches)} "
                             "batches)")

    # -- checks
    snap = server.gallery.snapshot()
    if snap.arr.dtype != torch.int8:
        raise AssertionError(f"{mode}: gallery {snap.arr.dtype}")
    min_sim = 1.0
    for b, ans in zip(batches, answers):
        emb, vals, idx = server.serving_embed(server.pad_batch(list(b)), snap)
        names = [snap.names[int(i)] for i in idx[:len(b), 0].cpu()]
        if [a["userId"] for a in ans] != names:
            raise AssertionError(f"{mode}: recognize_batch {ans} != "
                                 f"serving_embed {names}")
        _, plain_i = cosine_topk_int8_reference(snap.arr, snap.scales,
                                                emb.float(), snap.count, 1)
        if not torch.equal(plain_i[:len(b), 0], idx[:len(b), 0]):
            raise AssertionError(f"{mode}: userIds differ from the plain "
                                 "search")
        sims = vals[:len(b), 0].cpu().numpy()
        for j in range(min(len(b), len(enrolled_q))):
            u = enrolled_q[j] if len(b) > 1 else 0
            if names[j] != f"user{u:02d}" or sims[j] < 0.99:
                raise AssertionError(f"{mode}: enrolled crop {u}: got "
                                     f"{names[j]} at similarity {sims[j]}")
            min_sim = min(min_sim, float(sims[j]))

    # drift from the port's f32 float embedder (on the CPU)
    e_gpu = server.pipeline.embed_cropped_batch(batches[1])
    if not np.all(np.isfinite(e_gpu)) or e_gpu.shape != (8, DIM):
        raise AssertionError(f"{mode}: embeddings not finite (8, 512)")
    cos_dist = float((1 - (e_cpu * e_gpu).sum(-1)).max())
    if cos_dist > INT8_COS_DIST_MAX:
        raise AssertionError(f"{mode}: int8 card vs f32 CPU embeddings: "
                             f"cosine distance {cos_dist}")

    # batch invariance on the card: a 50x louder neighbour changes nothing
    with torch.inference_mode():
        x = rec_normalize(torch.tensor(batches[2],
                                       device=server.device).float())
        y = x.clone()
        y[3] *= 50.0
        net = server.pipeline.rec_net
        ex, ey = net(x), net(y)
    keep = [i for i in range(x.shape[0]) if i != 3]
    if not torch.equal(ex[keep], ey[keep]):
        raise AssertionError(f"{mode}: embeddings move with a loud batch "
                             "neighbour")

    # -- embed + match latency at each batch bucket
    def embed_match_ms(b, reps=12):
        ts = []
        for _ in range(reps):
            batch = rng.integers(0, 256, (b, rh, rw, 3), np.uint8)
            t0 = time.perf_counter()
            _, v, _ = server.serving_embed(server.pad_batch(list(batch)),
                                           snap)
            v.cpu()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts[2:])
    rec = {"phase": "server_throughput", "config": "configs/throughput.json",
           "scales": mode, "network": server.config.rec_network,
           "dtype": server.config.compute_dtype, "users": n_users,
           "batches": [len(b) for b in batches], "forwards": forwards,
           "gallery_capacity": server.gallery.capacity,
           "launches": counts, "cos_dist_vs_f32_cpu": cos_dist,
           "min_enrolled_similarity": min_sim, "batch_invariant": True,
           "embed_match_ms_b1": embed_match_ms(1),
           "embed_match_ms_b8": embed_match_ms(8),
           "embed_match_ms_b64": embed_match_ms(64)}
    emit(rec)
    return rec


def ir_block_bound(n, h, w, c, dtype):
    """Least time (ms) of one fused IR block on an H100 SXM and what bounds
    it: x read once, the output written once, both weights and the (5, C)
    f32 parameters read once; two convs of 2*N*H*W*9*C*C operations at the
    dtype's peak."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * n * h * w * c + 2 * 9 * c * c) * item + 5 * c * 4
    ops = 2 * (2 * n * h * w * 9 * c * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_ir_block(c, dtype, gen, device):
    """An IR-50 identity block (stride 1, no shortcut conv, no SE) with
    weights drawn from ``gen``; conv weights and PReLU slopes stored in
    ``dtype``, as ``ArcFace.set_compute_dtype`` stores them."""
    import torch

    from facekit_torch.models.arcface import IRBlock
    blk = IRBlock(c, c, 1, se=False)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    a = (6.0 / (9 * c)) ** 0.5
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.scale.copy_(uniform(c, 0.5, 1.5))
            bn.bias.copy_(uniform(c, -0.2, 0.2))
            bn.mean.copy_(uniform(c, -0.2, 0.2))
            bn.var.copy_(uniform(c, 0.5, 1.5))
        blk.conv1.copy_(uniform(blk.conv1.shape, -a, a))
        blk.conv2.copy_(uniform(blk.conv2.shape, -a, a))
        blk.prelu.copy_(uniform(c, 0.1, 0.4))
    for p in (blk.conv1, blk.conv2, blk.prelu):
        p.data = p.data.to(dtype)
    return blk.to(device).eval()


def phase_ir_block(device, seed=5):
    """Kernel #3, the fused IR block, against its plain version at the four
    IR-50 identity-block shapes, batch 8 and 64 (and 32 in bf16), bf16 and
    f32: f32 within IR_BLOCK_F32_ATOL; bf16 within two bf16 steps of each
    output (2**-6 of its magnitude, plus 2**-9 near 0) but for a share
    IR_BLOCK_BF16_PAST, and every output within that plus
    ``u_rounding_bound``: both versions
    round u to bf16 from f32 sums taken in another order (cuDNN's sums
    land farther from a float64 version's than the kernel's do).
    The block op by op (cuDNN convs, what the port ran before this kernel)
    is timed beside it as a guide: no single PyTorch call computes it."""
    import torch

    from facekit_torch.ops.ir_block import (_ir_block_cuda, block_operands,
                                            ir_block_reference,
                                            u_rounding_bound)
    gen = torch.Generator().manual_seed(seed)
    dgen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for hw, c, per_forward in IR_BLOCK_SHAPES:
            blk = random_ir_block(c, dt, gen, device)
            w1, w2, par = block_operands(blk, dt)
            for n in IR_BLOCK_BATCHES[dname]:
                xs = [torch.randn((n, hw, hw, c), generator=dgen,
                                  device=device).to(dt) for _ in range(2)]
                got = _ir_block_cuda(xs[0], w1, w2, par).float()
                ref = ir_block_reference(xs[0], w1, w2, par).float()
                err = (got - ref).abs()
                if dname == "float32":
                    past = float((err > IR_BLOCK_F32_ATOL).float().mean())
                    ok = past == 0.0
                else:
                    steps = 2.0 ** -6 * ref.abs() + 2.0 ** -9
                    past = float((err > steps).float().mean())
                    bound = u_rounding_bound(xs[0], w1, w2, par)
                    ok = past <= IR_BLOCK_BF16_PAST and \
                        bool((err <= steps + bound).all())
                    del steps, bound
                if not torch.isfinite(got).all() or not ok:
                    raise AssertionError(
                        f"ir_block {dname} {(n, hw, hw, c)}: differs from "
                        f"the plain version by up to {float(err.max())}, "
                        f"{past} of the outputs past the tolerance")
                args = [(x, w1, w2, par) for x in xs]
                bound, by = ir_block_bound(n, hw, hw, c, dname)
                with torch.inference_mode():
                    eager = cuda_ms(blk.composed, [(x,) for x in xs], 10)
                rec = {"phase": "ir_block_case", "dtype": dname,
                       "shape": {"N": n, "H": hw, "W": hw, "C": c},
                       "blocks_per_forward": per_forward,
                       "max_abs_err": float(err.max()),
                       "max_abs_ref": float(ref.abs().max()),
                       "share_past_tolerance": past,
                       "ms": cuda_ms(_ir_block_cuda, args, 10),
                       "plain_ms": cuda_ms(ir_block_reference, args, 3),
                       "eager_ms": eager, "library_ms": None,
                       "bound_ms": bound, "bound_by": by}
                emit(rec)
                out.append(rec)
                del xs, got, ref, err
    torch.cuda.synchronize()
    return out


def phase_server_inference(device, repo_dir, seed=6, n_users=32):
    """configs/default.json's WS /inference path on the card, at full
    width: 480x640 frames, RetinaFace-MobileNet0.25 at 288x320 with
    landmarks, 5-point alignment, IR-50 and the search in bf16, a bf16
    gallery of 32 users; the batch function WS /inference calls, at
    buckets 1 and 8. Each stage is checked against the port's f32 CPU path
    on the same inputs. The detector is the one the server draws without
    ``det_weights`` (numpy seed 0). Random detector weights score every
    anchor of any frame near 0.55 (they see mostly the letterbox's constant
    pad), so the shipped threshold of 0.6 would find no face; at 0.5 every
    frame has 4, and alignment, embedding and match run on valid slots."""
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.ops.align import warp_align_frames
    from facekit_torch.ops.similarity import cosine_topk_reference
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.server import FaceServer
    from facekit_torch.weights import (random_arcface_params,
                                       random_retinaface_params)

    rng = np.random.default_rng(seed)
    cfg = load_config(os.path.join(repo_dir, "configs", "default.json"))
    cfg = dataclasses.replace(cfg, det_threshold_bbox=0.5)
    rec_params = random_arcface_params(cfg.rec_network, seed=seed)
    det_params = random_retinaface_params(
        seed=0, with_landmarks=cfg.det_withLandmarks)
    fh, fw = cfg.frame_hw
    rh, rw = cfg.rec_hw
    frames = rng.integers(0, 256, (n_users + 4, fh, fw, 3), dtype=np.uint8)
    enrolled_q = [0, 5, 10, n_users - 1]
    queries = np.concatenate([frames[enrolled_q], frames[n_users:]])
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, database_path=os.path.join(
            tmp, "facekit.db"))
        server = FaceServer(cfg, rec_params=rec_params, device=device)
        pipe = server.pipeline
        try:
            reset_launches()
            # -- the main path: each user is a face of one of 32 frames,
            #    enrolled 8 frames per batch; then WS /inference's batch
            #    function at buckets 1 and 8
            for s in range(0, n_users, 8):
                res = pipe.recognize_frames(frames[s:s + 8],
                                            return_crops=True)
                # the valid slot with the most pixel variance: some slots
                # are boxes on the frame's edge with empty crops, alike in
                # every frame
                spread = res.crops.std(dim=(2, 3, 4)).masked_fill(
                    ~res.valid, -1.0)
                if (spread.amax(1) < 10).any():
                    raise AssertionError("a frame without a valid face that "
                                         "holds pixels")
                slot = spread.argmax(1).cpu()
                for j in range(8):
                    uid = f"user{s + j:02d}"
                    server.db.insert_user(uid, f"User {s + j}")
                    emb = res.embeddings[j, slot[j]].cpu().numpy()
                    if server.db.insert_face(uid, f"frame{s + j}.jpg",
                                             emb) != 1:
                        raise AssertionError(f"insert_face failed for {uid}")
            server.reload_gallery()
            answers = [server.inference_batch([queries[0]]),
                       server.inference_batch(list(queries))]
            torch.cuda.synchronize()
            counts = launches()
            forwards = n_users // 8 + 2
            if counts["ir_block"] != IR_BLOCKS_PER_FORWARD * forwards or \
                    counts["cosine_topk"] != 2 or \
                    counts["cosine_topk_int8"] or counts["conv_s8"]:
                raise AssertionError(f"launches on the /inference path of "
                                     f"configs/default.json ({forwards} "
                                     f"forwards): {counts}")

            # -- checks: the replies
            sims = []
            for j, u in enumerate(enrolled_q):
                a = answers[1][j]
                if a is None or a["userId"] != f"user{u:02d}" or \
                        a["similarity"] < 0.99:
                    raise AssertionError(f"frame of user {u}: reply {a}")
                sims.append(a["similarity"])
            if answers[0][0] is None or answers[0][0]["userId"] != "user00":
                raise AssertionError(f"bucket 1: reply {answers[0]}")
            for a in answers[0] + answers[1]:
                if a is None or a["crop"].dtype != np.uint8 or \
                        a["crop"].shape != (rh, rw, 3):
                    raise AssertionError("a reply without a uint8 crop")

            # -- checks, stage by stage, against the port's f32 CPU path
            cpu = FacePipeline(dataclasses.replace(cfg,
                                                   compute_dtype="float32"),
                               rec_params, det_params, device="cpu")
            q_cpu = torch.as_tensor(queries)
            q_dev = q_cpu.to(device)
            outs = pipe._detector_outputs(q_dev)
            det_err = {name: float((a.float().cpu() - b).abs().max())
                       for name, a, b in zip(("loc", "conf", "ldm"), outs,
                                             cpu._detector_outputs(q_cpu))}
            if any(det_err[k] > DET_ATOL[k] for k in DET_ATOL):
                raise AssertionError(f"detector on the card vs f32 CPU: "
                                     f"{det_err} (limits {DET_ATOL})")
            det = pipe._select_faces(*outs)
            c_det = cpu._select_faces(*(t.cpu() for t in outs))
            box_err = max(float((det.boxes.cpu() - c_det.boxes).abs().max()),
                          float((det.landmarks.cpu()
                                 - c_det.landmarks).abs().max()))
            if not torch.equal(det.valid.cpu(), c_det.valid) or \
                    box_err > 1e-3 or not det.valid.all():
                raise AssertionError(f"select_faces_batch on the card's "
                                     f"outputs: valid {det.valid.tolist()} "
                                     f"vs {c_det.valid.tolist()}, boxes and "
                                     f"landmarks up to {box_err} px apart")
            crops = warp_align_frames(q_dev, det.landmarks, cfg.rec_hw,
                                      dtype=pipe.dtype)
            c_crops = warp_align_frames(q_cpu, det.landmarks.cpu(),
                                        cfg.rec_hw, dtype=pipe.dtype)
            crop_err = float((crops.cpu() - c_crops).abs().max())
            if crop_err > CROP_ATOL:
                raise AssertionError(f"aligned crops on the card vs CPU: "
                                     f"{crop_err} apart")
            snap = server.gallery.snapshot()
            res, vals, idx = server.serving_recognize(
                server.pad_batch(list(queries)), snap)
            e_dev = res.embeddings.reshape(-1, DIM)
            e_cpu = cpu.embed_cropped_batch(
                res.crops.reshape(-1, rh, rw, 3).cpu().numpy())
            cos_dist = float((1 - (e_cpu * e_dev.cpu().numpy()).sum(-1))
                             .max())
            if not np.all(np.isfinite(e_cpu)) or cos_dist > COS_DIST_MAX:
                raise AssertionError(f"bf16 card vs f32 CPU embeddings: "
                                     f"cosine distance {cos_dist}")
            plain = cosine_topk_reference(snap.arr, e_dev.to(snap.arr.dtype),
                                          snap.count, 2)
            err = check_search("inference search", (vals.reshape(-1, 1),
                                                    idx.reshape(-1, 1)),
                               plain, 1)

            # -- frame-batch latency at each bucket, with the fused blocks
            #    and (a guide) with the blocks op by op, in turns
            def inference_ms(b, reps=10):
                ts = []
                for _ in range(reps):
                    batch = list(rng.integers(0, 256, (b, fh, fw, 3),
                                              np.uint8))
                    t0 = time.perf_counter()
                    server.inference_batch(batch)
                    ts.append((time.perf_counter() - t0) * 1e3)
                return ts[2:]
            lat = {}
            for _ in range(2):
                for b in (1, 8):
                    lat.setdefault(f"inference_ms_b{b}", []).extend(
                        inference_ms(b))
                    with composed_blocks():
                        lat.setdefault(f"inference_ms_b{b}_composed",
                                       []).extend(inference_ms(b))
            rec = {"phase": "server_inference",
                   "config": "configs/default.json",
                   "det_threshold_bbox": cfg.det_threshold_bbox,
                   "network": cfg.rec_network, "dtype": cfg.compute_dtype,
                   "users": n_users, "frames": [1, len(queries)],
                   "forwards": forwards, "launches": counts,
                   "faces_per_frame": det.valid.sum(1).tolist(),
                   "det_max_err": det_err, "box_max_err": box_err,
                   "crop_max_err": crop_err,
                   "cos_dist_vs_f32_cpu": cos_dist, "max_abs_err": err,
                   "min_enrolled_similarity": float(min(sims)),
                   **{k: statistics.median(v) for k, v in lat.items()}}
            emit(rec)
            return rec
        finally:
            server.close()


# the detector paths of server_detectors: (name, config override) on
# configs/default.json
DET_PATHS = (("slim", {"det_network": "slim"}),
             ("rfb_int8", {"det_network": "rfb", "det_quantize": True}),
             ("mobilenet0.25_int8", {"det_quantize": True}))
# int8 sites per forward of each detector family (47 in RetinaFace)
DET_INT8_SITES = {"mobilenet0.25": 47, "slim": 25, "rfb": 23}
DET_THRESHOLD = 0.5          # random detector weights score near 0.55
# facekit's int8 detector bars (tests/test_model_parity.py:311-369): conf
# within 1e-3 of float, loc and ldm within this share of their largest
INT8_DET_CONF_ATOL = 1e-3
INT8_DET_REL = 0.2


@contextlib.contextmanager
def recorded_convs():
    """Every ``conv_s8`` call of the int8 layers, recorded with its
    operands and result (``layers.conv2d_int8`` calls it by this name)."""
    from facekit_torch.models import layers as L
    real = L.conv_s8
    calls = []

    def record(x, w, stride=1, padding=0, groups=1):
        out = real(x, w, stride, padding, groups)
        calls.append((x, w, stride, padding, groups, out))
        return out
    L.conv_s8 = record
    try:
        yield calls
    finally:
        L.conv_s8 = real


def det_conv_cases(device, shapes, in_forward, gen):
    """One ``conv_s8_det_case`` line per distinct int8 detector site shape
    (N, H, W, C, O, k, stride, pad, groups; ``shapes`` maps each to its
    sites per forward on each path): the kernel against its plain
    version bit for bit on fresh random int8 operands; its CUDA-event ms;
    its traced device µs with the L2 flushed before each call, every
    case in one trace (``device_us``, the operands read from HBM as the
    bound counts them);
    the mean device µs of a site of this shape inside the served forward
    on each path (``in_forward_us``, from ``in_forward``); the bound; and
    cuDNN's bf16 conv of the same shape (``groups`` = C for the depthwise
    sites) as a guide only. A device time whose trace never held one
    kernel per call is None."""
    import torch
    import torch.nn.functional as F

    from facekit_torch.ops.conv_s8 import (conv_route, conv_s8,
                                           conv_s8_reference)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    out, timed = [], []                  # timed: (conv_s8, its args) a case
    for shape, per_forward in shapes.items():
        n, h, w, c, o, ks, stride, pad, groups = shape
        xs = [torch.randint(-127, 128, (n, h, w, c), generator=gen,
                            device=device, dtype=torch.int8)
              for _ in range(2)]
        wt = torch.randint(-127, 128, (o, ks, ks, c // groups),
                           generator=gen, device=device, dtype=torch.int8)
        got = conv_s8(xs[0], wt, stride, pad, groups)
        ref = conv_s8_reference(xs[0], wt, stride, pad, groups)
        if not torch.equal(got, ref):
            raise AssertionError(f"conv_s8 {shape}: {int((got != ref).sum())}"
                                 " outputs differ from the plain version")
        args = [(x, wt, stride, pad, groups) for x in xs]
        xb = [x.permute(0, 3, 1, 2).to(torch.bfloat16) for x in xs]
        wb = wt.permute(0, 3, 1, 2).to(torch.bfloat16)

        def cudnn(x_, w_):
            return F.conv2d(x_, w_, stride=stride, padding=pad,
                            groups=groups)
        bound, by = conv_bound(n, h, w, c, o, ks, stride, pad, groups)
        rec = {"phase": "conv_s8_det_case",
               "shape": {"N": n, "H": h, "W": w, "C": c, "O": o, "k": ks,
                         "stride": stride, "pad": pad, "groups": groups},
               "launches_per_forward": per_forward,
               "route": conv_route(c, groups), "max_abs_err": 0,
               "ms": cuda_ms(conv_s8, args, 20),
               "in_forward_us": {path: in_forward[path].get(shape)
                                 if in_forward.get(path) else None
                                 for path in per_forward},
               "plain_ms": cuda_ms(conv_s8_reference, args, 2),
               "bf16_cudnn_ms": cuda_ms(cudnn, [(x, wb) for x in xb], 20),
               "bound_ms": bound, "bound_by": by}
        out.append(rec)
        timed.append((conv_s8, args))
    for rec, us in zip(out, flushed_kernel_us(timed, "conv_s8", flush)):
        rec["device_us"] = us
        emit(rec)
    del flush, timed
    torch.cuda.synchronize()
    return out


# the conv_s8_det_case keys summed per forward (µs ones summed as ms)
DET_CASE_SUMS = ("ms", "device_us", "bound_ms", "plain_ms",
                 "bf16_cudnn_ms")


def det_case_sums(cases):
    """Per int8 detector path and batch, the ``conv_s8_det_case`` lines
    summed, each times its sites per forward on that path, in all and by
    route: the conv's ms per detector forward, its device ms alone with
    the L2 flushed (``device_ms``) and inside the served forward
    (``in_forward_device_ms``), beside its bound, the
    plain version and cuDNN's bf16 convs. A sum over a case whose device
    time is None is None."""
    out = {}

    def add(acc, c, per, in_forward):
        acc["sites"] += per
        for k, v in [*((k, c[k]) for k in DET_CASE_SUMS),
                     ("in_forward_device_us", in_forward)]:
            key = k.replace("_us", "_ms")
            if acc[key] is not None:
                acc[key] = None if v is None else \
                    acc[key] + v * per / (1e3 if "_us" in k else 1)

    def zero():
        return {"sites": 0, "in_forward_device_ms": 0.0,
                **{k.replace("_us", "_ms"): 0.0 for k in DET_CASE_SUMS}}
    for c in cases:
        for path, per in c["launches_per_forward"].items():
            acc = out.setdefault(f"{path} b{c['shape']['N']}",
                                 {**zero(), "by_route": {}})
            route = acc["by_route"].setdefault(c["route"], zero())
            for a in (acc, route):
                add(a, c, per, c["in_forward_us"][path])
    return out


def phase_server_detectors(device, repo_dir, seed=9, n_users=8):
    """WS /inference and uncropped /insert/face of configs/default.json
    with each detector other than the default one (``DET_PATHS``: slim in
    bf16; RFB and RetinaFace-MobileNet0.25 int8, their 23 / 47 backbone,
    FPN and SSH sites through ``conv_s8``), at full width: 480x640 frames,
    the detector at 288x320, IR-50 and the search in bf16, random weights
    from seeds (the detector the server draws without ``det_weights``).
    Per path: 8 users enrolled from the faces of 8 frames, then the WS
    batch function at buckets 1 and 8 and one ``/insert/face`` through the
    app, with every launch count set to 0 just before and read just after.
    Checks: the replies; slots equal to the plain path's on the card's own
    detector outputs; every int8 site's s32 sum bit-equal to
    ``conv_s8_reference`` on the card's own int8 input; the int8
    detector's drift against the float one, both at f32 on the card,
    within facekit's bars (a bf16 float detector against the f32 CPU one
    within DET_ATOL). Then the detector's traced device ms per forward
    with the share ``conv_s8`` takes, the WS batch latency at buckets 1
    and 8, and one ``conv_s8_det_case`` line per distinct site shape of
    the int8 paths at both buckets."""
    import asyncio

    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from facekit_torch.config import load_config
    from facekit_torch.models import quantize_detector
    from facekit_torch.ops.conv_s8 import conv_s8_reference
    from facekit_torch.ops.preprocess import det_normalize
    from facekit_torch.ops.resize import letterbox
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.pipeline.recognize import _detector
    from facekit_torch.server import FaceServer, make_app
    from facekit_torch.server.app import random_detector_params
    from facekit_torch.weights import random_arcface_params

    rng = np.random.default_rng(seed)
    base = load_config(os.path.join(repo_dir, "configs", "default.json"))
    rec_params = random_arcface_params(base.rec_network, seed=seed)
    fh, fw = base.frame_hw
    rh, rw = base.rec_hw
    frames = rng.integers(0, 256, (n_users + 4, fh, fw, 3), dtype=np.uint8)
    queries = np.concatenate([frames[[0, 3, 5, n_users - 1]],
                              frames[n_users:]])
    shapes = {}                      # site shape -> {path: per forward}
    in_forward = {}                  # path -> {site shape: device µs}
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        img_path = os.path.join(tmp, "whole.png")
        import cv2
        cv2.imwrite(img_path, frames[n_users])
        for name, override in DET_PATHS:
            cfg = dataclasses.replace(
                base, det_threshold_bbox=DET_THRESHOLD, api_imgIsCropped=False,
                database_path=os.path.join(tmp, f"{name}.db"), **override)
            family = cfg.det_network
            int8 = cfg.det_quantize
            order = {}               # batch -> site shapes in call order
            server = FaceServer(cfg, rec_params=rec_params, device=device)
            pipe = server.pipeline
            try:
                reset_launches()
                # -- the main path: 8 users from the faces of 8 frames; WS
                #    /inference's batch function at buckets 1 and 8; one
                #    uncropped /insert/face through the app
                res = pipe.recognize_frames(frames[:n_users],
                                            return_crops=True)
                spread = res.crops.std(dim=(2, 3, 4)).masked_fill(
                    ~res.valid, -1.0)
                if (spread.amax(1) < 10).any():
                    raise AssertionError(f"{name}: a frame without a valid "
                                         "face that holds pixels")
                slot = spread.argmax(1).cpu()
                for j in range(n_users):
                    uid = f"user{j:02d}"
                    server.db.insert_user(uid, f"User {j}")
                    if server.db.insert_face(
                            uid, f"frame{j}.jpg",
                            res.embeddings[j, slot[j]].cpu().numpy()) != 1:
                        raise AssertionError(f"insert_face failed for {uid}")
                server.reload_gallery()
                answers = [server.inference_batch([queries[0]]),
                           server.inference_batch(list(queries))]

                async def insert_face():
                    client = TestClient(TestServer(make_app(server)))
                    await client.start_server()
                    try:
                        await client.post("/insert/user", data=json.dumps(
                            {"userId": "whole", "userName": "Whole"}))
                        r = await client.post("/insert/face", data=json.dumps(
                            {"data": [{"userId": "whole",
                                       "imgPath": img_path}]}))
                        return await r.text()
                    finally:
                        await client.close()
                inserted = asyncio.run(insert_face())
                torch.cuda.synchronize()
                counts = launches()
                forwards = 4          # enrollment, two buckets, /insert/face
                if counts["conv_s8"] != (DET_INT8_SITES[family] * forwards
                                         if int8 else 0) or \
                        counts["ir_block"] != IR_BLOCKS_PER_FORWARD * \
                        forwards or counts["cosine_topk"] != 2 or \
                        counts["cosine_topk_int8"]:
                    raise AssertionError(f"launches on the {name} path "
                                         f"({forwards} forwards): {counts}")

                # -- checks: the replies
                for j, u in enumerate((0, 3, 5, n_users - 1)):
                    a = answers[1][j]
                    if a is None or a["userId"] != f"user{u:02d}" or \
                            a["similarity"] < 0.99:
                        raise AssertionError(f"{name} frame of user {u}: "
                                             f"reply {a}")
                if answers[0][0] is None or \
                        answers[0][0]["userId"] != "user00":
                    raise AssertionError(f"{name} bucket 1: {answers[0]}")
                for a in answers[0] + answers[1]:
                    if a is None or a["crop"].shape != (rh, rw, 3):
                        raise AssertionError(f"{name}: a reply without a "
                                             "crop")
                whole = pipe.recognize_frame(frames[n_users])
                nvalid = int(whole.valid.sum())
                expect = ("1 face found" if nvalid == 1 else
                          "There are more than 1 faces" if nvalid else
                          "Cant find any faces")
                if not inserted.startswith(expect):
                    raise AssertionError(f"{name} /insert/face: {inserted!r}"
                                         f" with {nvalid} faces")

                # -- checks, stage by stage, on the card's own outputs
                q_dev = torch.as_tensor(queries).to(device)
                with recorded_convs() as calls:
                    outs = pipe._detector_outputs(q_dev)
                    torch.cuda.synchronize()
                cpu_cfg = dataclasses.replace(
                    cfg, rec_network="ir_tiny", compute_dtype="float32",
                    det_quantize=False)
                det_params = random_detector_params(cfg, seed=0)
                cpu = FacePipeline(cpu_cfg, random_arcface_params(
                    "ir_tiny", seed=0), det_params, device="cpu")
                det = pipe._select_faces(*outs)
                c_det = cpu._select_faces(*(t.cpu() for t in outs))
                box_err = max(
                    float((det.boxes.cpu() - c_det.boxes).abs().max()),
                    float((det.landmarks.cpu()
                           - c_det.landmarks).abs().max()))
                if not torch.equal(det.valid.cpu(), c_det.valid) or \
                        box_err > 1e-3 or not det.valid.any():
                    raise AssertionError(
                        f"{name}: select_faces_batch on the card's outputs: "
                        f"valid {det.valid.tolist()} vs "
                        f"{c_det.valid.tolist()}, {box_err} px apart")
                above = float((outs[1][..., 1] > DET_THRESHOLD).float()
                              .mean())
                rec = {"phase": "server_detectors", "path": name,
                       "det_network": family, "det_quantize": int8,
                       "config": "configs/default.json",
                       "det_threshold_bbox": DET_THRESHOLD,
                       "network": cfg.rec_network, "dtype": cfg.compute_dtype,
                       "users": n_users, "frames": [1, len(queries)],
                       "forwards": forwards, "launches": counts,
                       "anchors": outs[1].shape[1],
                       "anchor_share_above_threshold": above,
                       "faces_per_frame": det.valid.sum(1).tolist(),
                       "insert_face_reply": inserted.splitlines()[0],
                       "box_max_err": box_err}
                x_dev = det_normalize(letterbox(q_dev.float(), cfg.det_hw))

                def det_forward(x):
                    with torch.inference_mode():
                        return pipe.det_net(x)
                if int8:
                    if len(calls) != DET_INT8_SITES[family]:
                        raise AssertionError(f"{name}: {len(calls)} int8 "
                                             "sites in one forward")
                    for x, w, stride, pad, groups, got in calls:
                        if not torch.equal(got, conv_s8_reference(
                                x, w, stride, pad, groups)):
                            raise AssertionError(
                                f"{name}: int8 site {tuple(x.shape)} -> "
                                f"{tuple(got.shape)} differs from the plain "
                                "version on the card's own input")
                    for b in (1, len(queries)):
                        with recorded_convs() as site_calls:
                            det_forward(x_dev[:b])
                        order[b] = [(*x.shape, w.shape[0], w.shape[1],
                                     stride, pad, groups)
                                    for x, w, stride, pad, groups, _
                                    in site_calls]
                        for key, count in collections.Counter(
                                order[b]).items():
                            shapes.setdefault(key, {})[name] = count
                    # drift of the int8 detector at f32 against the float
                    # one, both on the card
                    f32, _ = _detector(cpu_cfg, det_params, device)
                    f32 = f32.to(device).eval()
                    q32 = quantize_detector(f32)
                    with torch.inference_mode():
                        ref = f32(x_dev)
                        got = q32(x_dev)
                    drift = {"conf": float((got[1] - ref[1]).abs().max())}
                    for k, i in (("loc", 0), ("ldm", 2)):
                        drift[k] = float((got[i] - ref[i]).abs().max()
                                         / ref[i].abs().max())
                    if drift["conf"] > INT8_DET_CONF_ATOL or \
                            drift["loc"] > INT8_DET_REL or \
                            drift["ldm"] > INT8_DET_REL:
                        raise AssertionError(f"{name}: int8 vs float "
                                             f"detector at f32: {drift}")
                    rec["int8_sites_checked"] = len(calls)
                    rec["int8_drift_vs_f32"] = drift
                    del f32, q32
                else:
                    c_outs = cpu._detector_outputs(torch.as_tensor(queries))
                    det_err = {k: float((a.float().cpu() - b).abs().max())
                               for k, a, b in zip(("loc", "conf", "ldm"),
                                                  outs, c_outs)}
                    if any(det_err[k] > DET_ATOL[k] for k in DET_ATOL):
                        raise AssertionError(f"{name}: bf16 detector on the "
                                             f"card vs f32 CPU: {det_err}")
                    rec["det_max_err"] = det_err

                # -- the detector's device time per forward, and conv_s8's
                #    share of it (beside it, an int8 path's float detector
                #    in bf16, what the config serves without det_quantize);
                #    WS batch latency at each bucket
                if int8:
                    bf16, _ = _detector(cpu_cfg, det_params, device)
                    bf16 = bf16.set_compute_dtype(torch.bfloat16).to(
                        device).eval()

                    def bf16_forward(x):
                        with torch.inference_mode():
                            return bf16(x)
                    for b in (1, len(queries)):
                        events = traced_calls(bf16_forward, [(x_dev[:b],)])
                        key = f"b{1 if b == 1 else 8}"
                        rec[f"bf16_det_device_ms_{key}"] = sum(
                            us for _, _, us in events) / SPLIT_REPS / 1e3
                        rec[f"bf16_det_ms_{key}"] = cuda_ms(
                            bf16_forward, [(x_dev[:b],)], 10)
                    del bf16
                for b in (1, len(queries)):
                    for _ in range(TRACE_TRIES):
                        events = traced_calls(det_forward, [(x_dev[:b],)])
                        sites = site_us(events, order[b]) if int8 else None
                        if sites or not int8:
                            break
                    if int8:
                        in_forward.setdefault(name, {}).update(sites or {})
                    total = sum(us for _, _, us in events) / SPLIT_REPS
                    conv = sum(us for n_, _, us in events
                               if "conv_s8" in n_) / SPLIT_REPS
                    key = f"b{1 if b == 1 else 8}"
                    rec[f"det_device_ms_{key}"] = total / 1e3
                    rec[f"det_ops_per_forward_{key}"] = \
                        len(events) / SPLIT_REPS
                    rec[f"conv_s8_share_{key}"] = conv / total
                    rec[f"det_ms_{key}"] = cuda_ms(det_forward,
                                                   [(x_dev[:b],)], 10)

                def inference_ms(b, reps=8):
                    ts = []
                    for _ in range(reps):
                        batch = list(rng.integers(0, 256, (b, fh, fw, 3),
                                                  np.uint8))
                        t0 = time.perf_counter()
                        server.inference_batch(batch)
                        ts.append((time.perf_counter() - t0) * 1e3)
                    return ts[2:]
                lat = {}
                for _ in range(2):
                    for b in (1, 8):
                        lat.setdefault(f"inference_ms_b{b}", []).extend(
                            inference_ms(b))
                rec.update({k: statistics.median(v) for k, v in lat.items()})
                emit(rec)
                out.append(rec)
            finally:
                server.close()
    gen = torch.Generator(device=device).manual_seed(seed)
    cases = det_conv_cases(device, shapes, in_forward, gen)
    return out, cases


def _convert_cli(repo_dir, device, model, ckpt, out, extra=()):
    """``python -m facekit_torch.weights MODEL CKPT OUT --verify`` on
    ``device`` in its own process: (seconds, its ``verify`` line)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "facekit_torch.weights", model, ckpt, out,
         "--verify", "--device", device, *extra], cwd=repo_dir,
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    verify = [ln for ln in res.stdout.splitlines() if ln.startswith("verify")]
    if res.returncode != 0 or len(verify) != 1 or "True" not in verify[0]:
        raise AssertionError(f"weights CLI {model} failed (rc "
                             f"{res.returncode}): {res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    return seconds, verify[0]


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def phase_weights_gen(device, repo_dir, power, seed=8, n_classes=16,
                      per_class=4):
    """A deployment's steps before it serves, on the card, at full width
    (configs/default.json: IR-50 bf16, RetinaFace-MobileNet0.25 with
    landmarks): (a) full-width trees drawn from seeds are written as
    reference-layout state_dicts with torch.save (the detector's with
    ``module.`` prefixes under ``state_dict``); (b) the port's converter
    CLI turns each into a param file and ``--verify``s it on the card;
    (c) ``main()`` with ``gen: true`` and those files enrolls a tree of
    n_classes x per_class PNG crops; (d) one row per crop; (e) the rows
    equal, bit for bit, the embeddings of a server given the original
    tree; (f) /recognize through the app finds every crop as its own
    class at similarity >= 0.999; (g) /probe/device reports "gpu", and a
    second probe inside the cooldown gets 429."""
    import asyncio

    import cv2
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from facekit_torch.config import load_config
    from facekit_torch.db import Database
    from facekit_torch.server import FaceServer, make_app
    from facekit_torch.server.app import main as server_main
    from facekit_torch.weights import (load_params, random_arcface_params,
                                       random_retinaface_params)
    sys.path.insert(0, os.path.join(repo_dir, "tests"))
    from torch_reference_layout import (arcface_state_dict,
                                        retinaface_state_dict)

    with open(os.path.join(repo_dir, "configs", "default.json")) as f:
        raw = json.load(f)
    cfg = load_config(raw)
    rec_tree = random_arcface_params(cfg.rec_network, seed=seed)
    det_tree = random_retinaface_params(seed=seed + 1, with_landmarks=True)
    rng = np.random.default_rng(seed)
    rh, rw = cfg.rec_hw
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        # (a), (b)
        torch.save(arcface_state_dict(rec_tree), path("rec.pth"))
        torch.save({"state_dict": {f"module.{k}": v for k, v in
                                   retinaface_state_dict(det_tree).items()}},
                   path("det.pth"))
        rec_s, rec_verify = _convert_cli(
            repo_dir, device, "arcface", path("rec.pth"), path("rec.msgpack"),
            ("--network", cfg.rec_network))
        det_s, det_verify = _convert_cli(
            repo_dir, device, "retinaface", path("det.pth"), path("det.msgpack"))
        for file, tree in (("rec.msgpack", rec_tree),
                           ("det.msgpack", det_tree)):
            got, want = (_flat_leaves(load_params(path(file))),
                         _flat_leaves(tree))
            if sorted(got) != sorted(want) or any(
                    got[k].dtype != want[k].dtype
                    or got[k].tobytes() != want[k].tobytes() for k in want):
                raise AssertionError(f"{file}: leaves differ from the tree")

        # (c) gen mode through main()
        src = path("people")
        crops = {}
        for c in range(n_classes):
            cdir = os.path.join(src, f"person{c:02d}")
            os.makedirs(cdir)
            for i in range(per_class):
                img = rng.integers(0, 256, (rh, rw, 3), dtype=np.uint8)
                p = os.path.join(cdir, f"{i}.png")
                cv2.imwrite(p, img)
                crops[p] = (f"person{c:02d}", img)
        gen_cfg = dict(raw, gen=True, gen_imgSource=src,
                       gen_imgIsCropped=True, database_path=path("gen.db"),
                       rec_weights=path("rec.msgpack"),
                       det_weights=path("det.msgpack"))
        with open(path("gen.json"), "w") as f:
            json.dump(gen_cfg, f)
        enroll = FaceServer.enroll_folder
        enroll_s = []

        def timed_enroll(self, *args):
            t0 = time.perf_counter()
            n = enroll(self, *args)
            torch.cuda.synchronize()
            enroll_s.append(time.perf_counter() - t0)
            return n
        FaceServer.enroll_folder = timed_enroll
        try:
            reset_launches()
            t0 = time.perf_counter()
            server_main(["-c", path("gen.json"), "--device", device,
                         "--no-warmup"])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            gen_counts = launches()
        finally:
            FaceServer.enroll_folder = enroll
        n_imgs = n_classes * per_class
        forwards = -(-n_imgs // 8)                  # server_batchSize 8
        if gen_counts != {"cosine_topk": 0, "cosine_topk_int8": 0,
                          "conv_s8": 0,
                          "ir_block": IR_BLOCKS_PER_FORWARD * forwards}:
            raise AssertionError(f"launches on the gen path ({forwards} "
                                 f"forwards): {gen_counts}")

        # (d)
        db = Database(path("gen.db"), cfg.rec_outputDim)
        try:
            n_rows = db.get_num_embeddings()
            names, rows = db.get_embeddings()
            users = db.get_user_dict()
        finally:
            db.close()
        order = sorted(crops)
        if n_rows != n_imgs or names != [crops[p][0] for p in order] or \
                len(users) != n_classes:
            raise AssertionError(f"gen mode enrolled {n_rows} rows of "
                                 f"{len(users)} users, expected {n_imgs} "
                                 f"of {n_classes}")

        # (e) the original tree, carried over by from_jax
        plain = FaceServer(dataclasses.replace(
            cfg, database_path=path("plain.db")), rec_params=rec_tree,
            det_params=det_tree, device=device, warmup=False)
        try:
            imgs = np.stack([crops[p][1] for p in order])
            want = np.concatenate([
                plain.pipeline.embed_cropped_batch(
                    plain.pad_batch(list(imgs[i:i + 8])))[:len(imgs[i:i + 8])]
                for i in range(0, n_imgs, 8)])
        finally:
            plain.close()
        if not np.array_equal(rows, want):
            raise AssertionError(
                "gen rows differ from the original tree's embeddings by up "
                f"to {float(np.abs(rows - want).max())}")

        # (f), (g) a server over the enrolled database, through the app
        server = FaceServer(dataclasses.replace(
            cfg, database_path=path("gen.db"),
            rec_weights=path("rec.msgpack"),
            det_weights=path("det.msgpack")), device=device)

        async def drive():
            client = TestClient(TestServer(make_app(server)))
            await client.start_server()
            try:
                async def ask(p):
                    with open(p, "rb") as f:
                        r = await client.post("/recognize", data=f.read())
                    return r.status, await r.json()
                reset_launches()
                answers = await asyncio.gather(*(ask(p) for p in order))
                torch.cuda.synchronize()
                counts = launches()
                probes = []
                for _ in range(2):
                    r = await client.get("/probe/device?mb=8")
                    probes.append((r.status, await r.text()))
                return answers, counts, probes
            finally:
                await client.close()
        try:
            answers, counts, probes = asyncio.run(drive())
        finally:
            server.close()
        sims = []
        for p, (status, ans) in zip(order, answers):
            if status != 200 or not ans or ans["userId"] != crops[p][0] \
                    or ans["similarity"] < 0.999:
                raise AssertionError(f"/recognize {p}: {status} {ans}")
            sims.append(ans["similarity"])
        if counts["cosine_topk"] < 1 or counts["conv_s8"] or \
                counts["cosine_topk_int8"] or counts["ir_block"] < \
                IR_BLOCKS_PER_FORWARD * forwards or \
                counts["ir_block"] % IR_BLOCKS_PER_FORWARD:
            raise AssertionError(f"launches on /recognize: {counts}")
        (s1, body1), (s2, _) = probes
        probe = json.loads(body1) if s1 == 200 else {}
        if s1 != 200 or probe.get("platform") != "gpu" or s2 != 429:
            raise AssertionError(f"/probe/device: {probes}")
    rec = {"phase": "weights_gen", "config": "configs/default.json",
           "network": cfg.rec_network, "dtype": cfg.compute_dtype,
           "convert_s": {"arcface": rec_s, "retinaface": det_s},
           "verify": {"arcface": rec_verify, "retinaface": det_verify},
           "images": n_imgs, "classes": n_classes,
           "gen_main_s": main_s, "enroll_s": enroll_s[0],
           "enroll_images_per_s": n_imgs / enroll_s[0],
           "gen_launches": gen_counts, "recognize_launches": counts,
           "min_self_similarity": min(sims),
           "probe": {k: probe[k] for k in ("bytes", "upload_MBps",
                                           "dispatch_ms", "platform")},
           "probe_again_status": s2, "nvidia_smi": power}
    emit(rec)
    return rec



# -- server_engines: the exported engines of both shipped configs -------------

ENGINE_CONFIGS = ("default", "throughput")
ENGINE_REPS = 8              # latency samples per bucket, mode and turn


def _engine_export_cli(repo_dir, device, cfg_path, out):
    """``python -m facekit_torch.engine export -c CFG -o OUT`` on
    ``device`` in its own process: (seconds, one record per file)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "facekit_torch.engine", "export", "-c",
         cfg_path, "-o", out, "--device", device], cwd=repo_dir,
        capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    records = [json.loads(ln) for ln in res.stdout.splitlines()
               if ln.startswith("{")]
    if res.returncode != 0 or not records:
        raise AssertionError(f"engine export CLI failed (rc "
                             f"{res.returncode}): {res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    return seconds, records


@contextlib.contextmanager
def eager_serving(server):
    """``server`` serving from its eager pipeline, engines set aside: the
    same params, state and gallery, so replies compare one to one."""
    engines, server.engines = server.engines, None
    try:
        yield server
    finally:
        server.engines = engines


def _same_replies(a, b, what):
    """Two lists of server replies equal: userIds, names, flags and
    similarities exactly, crops pixel for pixel."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} replies against {len(b)}")
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: {x} against {y}")
        if x is None:
            continue
        if {k: v for k, v in x.items() if k != "crop"} != \
                {k: v for k, v in y.items() if k != "crop"}:
            raise AssertionError(f"{what}: {x} against {y}")
        if "crop" in x and not np.array_equal(x["crop"], y["crop"]):
            raise AssertionError(f"{what}: the crops differ")


def dispatch_cost(device, seed=11):
    """Per-call cost of the registered op against the direct wrapper:
    ``ir_block`` at batch 8 (bf16, 56x56x64) and ``conv_s8`` at an IR-50
    site (batch 8, 28x28x128, 3x3): host µs to issue a call on an idle
    card, and ms per call by CUDA events over calls back to back."""
    import torch

    from facekit_torch.ops.conv_s8 import _conv_s8_cuda
    from facekit_torch.ops.ir_block import _ir_block_cuda

    gen = torch.Generator(device=device).manual_seed(seed)
    c = 64
    x = torch.randn((8, 56, 56, c), generator=gen, device=device).to(
        torch.bfloat16)
    w1, w2 = (torch.randn((c, 3, 3, c), generator=gen, device=device).mul(
        0.05).to(torch.bfloat16) for _ in range(2))
    par = torch.rand((5, c), generator=gen, device=device) + 0.5
    x8 = torch.randint(-127, 128, (8, 28, 28, 128), generator=gen,
                       device=device, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (128, 3, 3, 128), generator=gen,
                       device=device, dtype=torch.int8)
    ops = torch.ops.facekit_torch
    cases = {"ir_block": ((x, w1, w2, par), ops.ir_block, _ir_block_cuda),
             "conv_s8": ((x8, w8, 1, 1, 1), ops.conv_s8, _conv_s8_cuda)}
    out = {}
    for name, (args, op, direct) in cases.items():
        row = {}
        for _ in range(2):                                  # in turns
            for tag, fn in (("op", op), ("direct", direct), ("direct", direct),
                            ("op", op)):
                row.setdefault(f"{tag}_host_us", []).append(
                    host_us(fn, [args], reps=50))
                row.setdefault(f"{tag}_ms", []).append(
                    cuda_ms(fn, [args], iters=200))
        out[name] = {k: statistics.median(v) for k, v in row.items()}
        out[name]["extra_host_us"] = (out[name]["op_host_us"]
                                      - out[name]["direct_host_us"])
    return out


def phase_server_engines(device, repo_dir, seed=10, n_users=8):
    """Both shipped configs served from exported engines on the card, at
    full width: configs/default.json (RetinaFace-MobileNet0.25 at 288x320,
    bf16 IR-50, buckets 1 and 8) and configs/throughput.json (int8 IR-50
    calibrated from a folder of crops, int8 gallery, buckets 1, 8, 64).
    For each: the export CLI in its own process (seconds and bytes per
    file); the seconds from ``FaceServer(...)`` to ready, eager and from
    the engines; n_users faces of frames and n_users crops enrolled; at
    every bucket WS ``/inference``'s and ``/recognize``'s batch functions
    from the engines, held reply for reply (crops pixel for pixel) and
    embedding for embedding to the same server's eager pipeline, with
    the same kernel launches; then both latencies in turns. Random
    detector weights: threshold 0.5, as ``server_inference``. Last, the
    dispatcher's cost per call (``dispatch_cost``)."""
    import cv2
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.server import FaceServer

    rng = np.random.default_rng(seed)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        crops_dir = os.path.join(tmp, "calibration")
        os.mkdir(crops_dir)
        for i in range(16):
            cv2.imwrite(os.path.join(crops_dir, f"c{i:02d}.png"),
                        rng.integers(0, 256, (112, 112, 3), dtype=np.uint8))
        for name in ENGINE_CONFIGS:
            with open(os.path.join(repo_dir, "configs", f"{name}.json")) as f:
                raw = json.load(f)
            raw["det_threshold_bbox"] = DET_THRESHOLD
            if "rec_calibrationDir" in raw:
                raw["rec_calibrationDir"] = crops_dir
            cfg_path = os.path.join(tmp, f"{name}.json")
            with open(cfg_path, "w") as f:
                json.dump(raw, f)
            eng_dir = os.path.join(tmp, f"{name}_engines")
            export_s, files = _engine_export_cli(repo_dir, device, cfg_path,
                                                 eng_dir)
            cfg = load_config(cfg_path)
            boot = {}
            for mode in ("eager", "engines"):
                run_cfg = dataclasses.replace(cfg, database_path=os.path.join(
                    tmp, f"{name}_{mode}.db"))
                t0 = time.perf_counter()
                server = FaceServer(run_cfg, device=device, engines_dir=(
                    eng_dir if mode == "engines" else None))
                torch.cuda.synchronize()
                boot[mode] = time.perf_counter() - t0
                if mode == "eager":
                    server.close()
                    del server
            try:
                results.append(_engines_run(server, name, rng, n_users,
                                            export_s, files, boot))
            finally:
                server.close()
    cost = dispatch_cost(device)
    emit({"phase": "dispatch_cost", **cost})
    return results, cost


def _engines_run(server, name, rng, n_users, export_s, files, boot):
    import torch

    cfg = server.config
    fh, fw = cfg.frame_hw
    rh, rw = cfg.rec_hw
    if server.calibrated != bool(cfg.rec_quantize):
        raise AssertionError(f"{name}: calibrated {server.calibrated}")
    # -- enrollment (eager, as in every mode): a face of each of n_users
    #    frames (the slot whose crop holds the most pixel variance) and
    #    n_users crops
    frames = rng.integers(0, 256, (n_users, fh, fw, 3), dtype=np.uint8)
    crops = rng.integers(0, 256, (n_users, rh, rw, 3), dtype=np.uint8)
    res = server.pipeline.recognize_frames(frames, return_crops=True)
    spread = res.crops.std(dim=(2, 3, 4)).masked_fill(~res.valid, -1.0)
    slot = spread.argmax(1).cpu()
    for u in range(n_users):
        for kind, emb in (("f", res.embeddings[u, slot[u]].cpu().numpy()),
                          ("c", server.pipeline.embed_cropped(crops[u]))):
            uid = f"{kind}{u:02d}"
            server.db.insert_user(uid, uid.upper())
            if server.db.insert_face(uid, f"{uid}.png", emb) != 1:
                raise AssertionError(f"insert_face failed for {uid}")
    server.reload_gallery()

    # -- every bucket from the engines, then eagerly, on the same server
    def batches(b, pool):
        n = min(b, 4)
        fresh = rng.integers(0, 256, (b - n, *pool.shape[1:]), np.uint8)
        return list(pool[:n]) + list(fresh)
    queries = {b: (batches(b, frames), batches(b, crops))
               for b in server.batch_buckets}

    def serve():
        return {b: (server.inference_batch(fq), server.recognize_batch(cq))
                for b, (fq, cq) in queries.items()}
    runs = {}
    for mode in ("engines", "eager"):
        with (eager_serving(server) if mode == "eager"
              else contextlib.nullcontext()):
            reset_launches()
            replies = serve()
            torch.cuda.synchronize()
            runs[mode] = (replies, launches())
    if runs["engines"][1] != runs["eager"][1]:
        raise AssertionError(f"{name}: launches from the engines "
                             f"{runs['engines'][1]} against eager "
                             f"{runs['eager'][1]}")
    counts = runs["engines"][1]
    forwards = 2 * len(server.batch_buckets)
    int8 = bool(cfg.rec_quantize)
    want = {"ir_block": 0 if int8 else 20 * forwards,
            "conv_s8": 52 * forwards if int8 else 0}
    if any(counts[k] != v for k, v in want.items()) or \
            counts["cosine_topk_int8" if int8 else "cosine_topk"] != forwards:
        raise AssertionError(f"{name}: launches {counts} ({forwards} "
                             "forwards)")
    min_sim = 1.0
    for b, (ws, rec) in runs["engines"][0].items():
        ews, erec = runs["eager"][0][b]
        _same_replies(ws, ews, f"{name} WS bucket {b}")
        _same_replies(rec, erec, f"{name} /recognize bucket {b}")
        for j in range(min(b, 4)):
            for kind, reply in (("f", ws[j]), ("c", rec[j])):
                if reply is None or reply["userId"] != f"{kind}{j:02d}" or \
                        reply["similarity"] < 0.99:
                    raise AssertionError(f"{name} bucket {b}: enrolled "
                                         f"{kind}{j:02d} answered {reply}")
                min_sim = min(min_sim, reply["similarity"])
    # the programs' outputs, tensor for tensor, at the top bucket
    snap = server.gallery.snapshot()
    top = server.batch_buckets[-1]
    fq, cq = (server.pad_batch(q) for q in queries[top])
    eng = (server.serving_recognize(fq, snap), server.serving_embed(cq, snap))
    with eager_serving(server):
        ref = (server.serving_recognize(fq, snap),
               server.serving_embed(cq, snap))
    (res_e, *m_e), emb_e = eng[0], eng[1]
    (res_r, *m_r), emb_r = ref[0], ref[1]
    pairs = [(a, b) for a, b in zip(res_e[:4] + (res_e.crops,),
                                    res_r[:4] + (res_r.crops,))]
    pairs += list(zip(m_e, m_r)) + list(zip(emb_e, emb_r))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    if not bit_equal:
        raise AssertionError(f"{name}: engine outputs differ from eager: "
                             + str([float((a.float() - b.float()).abs()
                                          .max()) for a, b in pairs]))

    # -- latency, engines and eager in turns (E, e, e, E), on two fresh
    #    batches a bucket taken in turn
    inputs = {(b, kind): [list(rng.integers(0, 256, (b, *pool.shape[1:]),
                                            np.uint8)) for _ in range(2)]
              for b in server.batch_buckets
              for kind, pool in (("inference", frames),
                                 ("recognize", crops))}

    def ms(fn, batches):
        ts = []
        for i in range(ENGINE_REPS + 1):
            t0 = time.perf_counter()
            fn(batches[i % 2])
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts[1:]
    lat = collections.defaultdict(list)
    for mode in ("engines", "eager", "eager", "engines"):
        with (eager_serving(server) if mode == "eager"
              else contextlib.nullcontext()):
            for (b, kind), batches in inputs.items():
                fn = (server.inference_batch if kind == "inference"
                      else server.recognize_batch)
                lat[f"{kind}_ms_b{b}_{mode}"] += ms(fn, batches)
    # -- where the time of one call goes, at bucket 1, engines and eager
    traces = {}
    for mode in ("engines", "eager"):
        with (eager_serving(server) if mode == "eager"
              else contextlib.nullcontext()):
            for kind, fn in (("inference", server.inference_batch),
                             ("recognize", server.recognize_batch)):
                traces[f"{kind}_b1_{mode}"] = call_trace(
                    fn, inputs[(1, kind)][0])
    rec = {"phase": "server_engines", "config": f"configs/{name}.json",
           "det_threshold_bbox": cfg.det_threshold_bbox,
           "network": cfg.rec_network, "dtype": cfg.compute_dtype,
           "rec_quantize": int8, "calibrated": server.calibrated,
           "buckets": server.batch_buckets, "export_cli_s": export_s,
           "files": files, "boot_s": boot, "users": 2 * n_users,
           "launches": counts, "bit_equal": bit_equal,
           "min_enrolled_similarity": min_sim,
           **{k: statistics.median(v) for k, v in sorted(lat.items())},
           "traces": traces}
    emit(rec)
    return rec


# -- server_remainder: native host ops, int8-residual, windowed align ----------

REMAINDER_REPS = 8           # latency samples per backend or mode and turn
DECODE_REPS = 40             # host decodes per backend and turn
SLICE_WIN = 320              # warp_align_frames' window in server_remainder
RESIDUAL_USERS = 16


def _smooth_images(rng, n, hw):
    """n uint8 BGR images of size ``hw``, random at a tenth of the size and
    resized up: JPEGs of these decode like photographs, not like noise."""
    import cv2
    h, w = hw
    small = rng.integers(0, 256, (n, max(h // 10, 2), max(w // 10, 2), 3),
                         dtype=np.uint8)
    return np.stack([cv2.resize(s, (w, h), interpolation=cv2.INTER_CUBIC)
                     for s in small])


def phase_server_remainder(device, repo_dir, seed=12):
    """What facekit serves on one device that the port served last:
    ``server_hostOps: "native"`` (``_remainder_native``), the int8-residual
    embedder (``_remainder_residual``) and the windowed alignment
    (``_remainder_windowed``), at full width. Returns their records."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nat = _remainder_native(device, repo_dir, tmp, seed)
        res = _remainder_residual(device, repo_dir, tmp, seed + 1)
    win = _remainder_windowed(device, seed + 2)
    emit({"phase": "server_remainder", "part": "seconds",
          "seconds": time.perf_counter() - t0})
    return nat, res, win


def _remainder_native(device, repo_dir, tmp, seed):
    """configs/default.json served on the native pixel backend and on the
    cv2 one, the same weights (random, from seeds) on both, det threshold
    0.5 as ``server_inference``. Each server: 8 users enrolled from the
    faces of 8 decoded 640x480 JPEG frames and 2 through ``/insert/face``
    of 112x112 JPEG files; then ``/recognize`` of 4 JPEG crops and a PNG,
    WS ``/inference`` of 3 JPEG frames and a PNG (one at a time, so each
    runs at bucket 1) through the app, and the WS batch function at
    buckets 1 and 8 on the frames the server decodes; launches counted
    over all of it. Every reply, crop and similarity must equal the cv2
    server's (the JPEGs are at their target size, so no resize runs);
    the PNG gets "null" from the JPEG-only native backend. Then host
    decode µs per 640x480 JPEG and WS round trips, in turns. Where the
    native library cannot be built, the server must refuse the config
    with the build's message instead."""
    import asyncio

    import cv2
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from facekit_torch import native
    from facekit_torch.config import load_config
    from facekit_torch.server import FaceServer, make_app
    from facekit_torch.weights import random_arcface_params

    rng = np.random.default_rng(seed)
    base = load_config(os.path.join(repo_dir, "configs", "default.json"))
    base = dataclasses.replace(base, det_threshold_bbox=DET_THRESHOLD)
    rec_params = random_arcface_params(base.rec_network, seed=seed)

    def config(host_ops):
        extras = dict(base.extras)
        if host_ops == "native":
            extras["server_hostOps"] = "native"
        return dataclasses.replace(base, extras=extras, database_path=(
            os.path.join(tmp, f"{host_ops}.db")))

    if not native.available():
        msg = native.build_error()
        try:
            FaceServer(config("native"), rec_params=rec_params,
                       device=device, warmup=False)
        except RuntimeError as e:
            if msg not in str(e):
                raise AssertionError(f"native refusal without the build's "
                                     f"message: {e}") from e
        else:
            raise AssertionError("a native server started without its "
                                 "library")
        print("server_remainder: the native host ops do not build on this "
              "machine; the server refuses server_hostOps native: "
              + msg.replace("\n", " | "), flush=True)
        rec = {"phase": "server_remainder", "part": "native",
               "refused": msg}
        emit(rec)
        return rec

    fh, fw = base.frame_hw
    rh, rw = base.rec_hw
    frames = _smooth_images(rng, 8, (fh, fw))
    crops = _smooth_images(rng, 4, (rh, rw))
    frame_jpgs = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    crop_jpgs = [cv2.imencode(".jpg", c)[1].tobytes() for c in crops]
    png = cv2.imencode(".png", crops[0])[1].tobytes()
    crop_paths = []
    for i, data in enumerate(crop_jpgs[:2]):
        crop_paths.append(os.path.join(tmp, f"crop{i}.jpg"))
        with open(crop_paths[-1], "wb") as f:
            f.write(data)
    servers = {hp: FaceServer(config(hp), rec_params=rec_params,
                              device=device) for hp in ("native", "cv2")}
    if servers["native"].pixels.name != "native" or \
            servers["cv2"].pixels.name != "cv2":
        raise AssertionError("the servers' pixel backends")

    async def drive(server, client):
        """The main path on one server; (replies, launches)."""
        px = server.pixels
        reset_launches()
        decoded = [px.decode(d, (fw, fh)) for d in frame_jpgs]
        res = server.pipeline.recognize_frames(np.stack(decoded),
                                               return_crops=True)
        spread = res.crops.std(dim=(2, 3, 4)).masked_fill(~res.valid, -1.0)
        slot = spread.argmax(1).cpu()
        for j in range(len(frame_jpgs)):
            server.db.insert_user(f"f{j}", f"F{j}")
            server.db.insert_face(f"f{j}", f"f{j}.jpg",
                                  res.embeddings[j, slot[j]].cpu().numpy())
        out = {"insert": []}
        for i, path in enumerate(crop_paths):
            await client.post("/insert/user", data=json.dumps(
                {"userId": f"c{i}", "userName": f"C{i}"}))
            r = await client.post("/insert/face", data=json.dumps(
                {"data": [{"userId": f"c{i}", "imgPath": path}]}))
            out["insert"].append(await r.text())
        await client.get("/reload")
        out["recognize"] = [await (await client.post(
            "/recognize", data=d)).text() for d in crop_jpgs + [png]]
        ws = await client.ws_connect("/inference")
        out["ws"] = []
        for d in frame_jpgs[:3] + [png]:
            await ws.send_bytes(d)
            out["ws"].append((await ws.receive()).data)
        await ws.close()
        out["batch"] = [server.inference_batch(decoded[:1]),
                        server.inference_batch(decoded)]
        torch.cuda.synchronize()
        return out, launches()

    async def ws_round_trips(client, reps):
        ws = await client.ws_connect("/inference")
        ts = []
        for i in range(reps + 1):
            t0 = time.perf_counter()
            await ws.send_bytes(frame_jpgs[i % len(frame_jpgs)])
            await ws.receive()
            ts.append((time.perf_counter() - t0) * 1e3)
        await ws.close()
        return ts[1:]

    async def run():
        clients = {hp: TestClient(TestServer(make_app(s)))
                   for hp, s in servers.items()}
        for c in clients.values():
            await c.start_server()
        try:
            runs = {hp: await drive(servers[hp], clients[hp])
                    for hp in ("native", "cv2")}
            lat = collections.defaultdict(list)
            for hp in ("native", "cv2", "cv2", "native"):
                lat[hp] += await ws_round_trips(clients[hp], REMAINDER_REPS)
            return runs, lat
        finally:
            for c in clients.values():
                await c.close()
    try:
        runs, ws_ms = asyncio.run(run())
        # host decode of one 640x480 JPEG, in turns
        dec = collections.defaultdict(list)
        for hp in ("native", "cv2", "cv2", "native"):
            px = servers[hp].pixels
            for i in range(DECODE_REPS):
                t0 = time.perf_counter()
                px.decode(frame_jpgs[i % len(frame_jpgs)])
                dec[hp].append((time.perf_counter() - t0) * 1e6)
    finally:
        for s in servers.values():
            s.close()

    # -- checks
    (nat, n_counts), (ref, c_counts) = runs["native"], runs["cv2"]
    # per server: 1 enrollment forward, 2 /insert/face, 4 /recognize, 3 WS
    # frames, 2 batches; the cv2 server also answers both PNGs
    for hp, counts, extra in (("native", n_counts, 0), ("cv2", c_counts, 2)):
        searches = 4 + 3 + 2 + extra
        want = {"ir_block": IR_BLOCKS_PER_FORWARD * (3 + searches),
                "cosine_topk": searches, "conv_s8": 0,
                "cosine_topk_int8": 0}
        if counts != want:
            raise AssertionError(f"native pixels, {hp} server: launches "
                                 f"{counts}, expected {want}")
    if nat["insert"] != ref["insert"] or \
            not all("inserted successfully" in t for t in nat["insert"]):
        raise AssertionError(f"/insert/face: {nat['insert']} against "
                             f"{ref['insert']}")
    if nat["recognize"][:4] != ref["recognize"][:4]:
        raise AssertionError(f"/recognize: {nat['recognize']} against "
                             f"{ref['recognize']}")
    for i in range(2):
        if json.loads(nat["recognize"][i])["userId"] != f"c{i}":
            raise AssertionError(f"/recognize of c{i}: "
                                 f"{nat['recognize'][i]}")
    if nat["recognize"][4] != "null" or ref["recognize"][4] == "null" or \
            nat["ws"][3] != "null" or ref["ws"][3] == "null":
        raise AssertionError("a PNG payload: native "
                             f"{nat['recognize'][4][:40]} / {nat['ws'][3][:40]}"
                             f", cv2 {ref['recognize'][4][:40]} / "
                             f"{ref['ws'][3][:40]}")
    jpeg_bytes_equal, crop_mad = True, 0.0
    for got, want in zip(nat["ws"][:3], ref["ws"][:3]):
        got, want = json.loads(got), json.loads(want)
        b_n, b_c = (base64.b64decode(d.pop("image")) for d in (got, want))
        if got != want:
            raise AssertionError(f"WS reply {got} against {want}")
        jpeg_bytes_equal &= b_n == b_c
        i_n, i_c = (cv2.imdecode(np.frombuffer(b, np.uint8),
                                 cv2.IMREAD_COLOR) for b in (b_n, b_c))
        crop_mad = max(crop_mad, float(np.abs(i_n.astype(int)
                                              - i_c.astype(int)).mean()))
    for got, want in zip(nat["batch"], ref["batch"]):
        _same_replies(got, want, "native pixels, WS batch")
    best = [a["similarity"] for a in nat["batch"][1] if a is not None]
    rec = {"phase": "server_remainder", "part": "native",
           "config": "configs/default.json", "server_hostOps": "native",
           "det_threshold_bbox": DET_THRESHOLD,
           "frames": [1, len(frame_jpgs)], "launches": {"native": n_counts,
                                                        "cv2": c_counts},
           "replies_bit_equal": True, "ws_jpeg_bytes_equal": jpeg_bytes_equal,
           "ws_crop_jpeg_mean_abs_diff": crop_mad,
           "png_reply": nat["recognize"][4],
           "batch8_best_similarities": best,
           "decode_us_640x480": {hp: statistics.median(v)
                                 for hp, v in dec.items()},
           "ws_round_trip_ms_b1": {hp: statistics.median(v)
                                   for hp, v in ws_ms.items()}}
    emit(rec)
    return rec


def _remainder_residual(device, repo_dir, tmp, seed):
    """configs/throughput.json calibrated from a folder of crops, with
    ``rec_int8Residual`` and without: the residual server's main path (16
    crops enrolled, ``/recognize``'s batch function at 1, 8 and 64 crops,
    launches counted: 52 ``conv_s8`` per forward, one int8 search per
    batch), every site's s32 sum of one forward held to
    ``conv_s8_reference`` on the card's own input, the drift of both int8
    forms from the f32 float embedder on the card (facekit's relation:
    residual < max(5 x calibrated, 2e-2)), device ms and operations per
    forward from a trace at batches 1, 8 and 64 and ``/recognize``
    latency, both forms in turns. Last, a residual engine pair exported
    and served at bucket 1: metadata ``rec_int8_residual``, replies and
    outputs bit-equal to the same server's eager pipeline."""
    import cv2
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.engine import export_engines, read_meta
    from facekit_torch.ops.conv_s8 import conv_s8_reference
    from facekit_torch.ops.preprocess import rec_normalize
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.server import FaceServer
    from facekit_torch.weights import random_arcface_params

    rng = np.random.default_rng(seed)
    cfg = load_config(os.path.join(repo_dir, "configs", "throughput.json"))
    cfg = dataclasses.replace(cfg, det_threshold_bbox=DET_THRESHOLD)
    params = random_arcface_params(cfg.rec_network, seed=seed)
    rh, rw = cfg.rec_hw
    n = RESIDUAL_USERS
    crops = rng.integers(0, 256, (n, rh, rw, 3), dtype=np.uint8)
    fresh = rng.integers(0, 256, (64, rh, rw, 3), dtype=np.uint8)
    enrolled_q = [0, 5, 10, n - 1]
    batches = [crops[:1], np.concatenate([crops[enrolled_q], fresh[:4]]),
               np.concatenate([crops[enrolled_q], fresh[:60]])]
    calib_dir = os.path.join(tmp, "calibration")
    os.mkdir(calib_dir)
    for i, c in enumerate(crops):
        cv2.imwrite(os.path.join(calib_dir, f"c{i:02d}.jpg"), c)

    def config(mode, **extra):
        extras = dict(cfg.extras, rec_calibrationDir=calib_dir, **extra)
        if mode == "residual":
            extras["rec_int8Residual"] = True
        return dataclasses.replace(cfg, extras=extras, database_path=(
            os.path.join(tmp, f"{mode}{len(extra)}.db")))

    servers = {m: FaceServer(config(m), rec_params=params, device=device)
               for m in ("residual", "calibrated")}
    try:
        res, cal = servers["residual"], servers["calibrated"]
        if res.pipeline.rec_net.int8 != "residual" or \
                cal.pipeline.rec_net.int8 != "static":
            raise AssertionError("the embedders' forms")
        # -- the main path
        reset_launches()
        for u in range(n):
            res.db.insert_user(f"u{u:02d}", f"U{u}")
            if res.db.insert_face(f"u{u:02d}", f"c{u}.jpg",
                                  res.pipeline.embed_cropped(crops[u])) != 1:
                raise AssertionError("insert_face failed")
        res.reload_gallery()
        answers = [res.recognize_batch(list(b)) for b in batches]
        torch.cuda.synchronize()
        counts = launches()
        forwards = n + len(batches)
        want = {"conv_s8": SITES_PER_FORWARD * forwards,
                "cosine_topk_int8": len(batches), "cosine_topk": 0,
                "ir_block": 0}
        if counts != want:
            raise AssertionError(f"residual path: launches {counts}, "
                                 f"expected {want}")
        min_sim = 1.0
        for b, ans in zip(batches, answers):
            for j in range(min(len(b), len(enrolled_q))):
                u = enrolled_q[j] if len(b) > 1 else 0
                if ans[j]["userId"] != f"u{u:02d}" or \
                        ans[j]["similarity"] < 0.99:
                    raise AssertionError(f"residual: enrolled crop {u} "
                                         f"answered {ans[j]}")
                min_sim = min(min_sim, ans[j]["similarity"])

        # -- every site's sum against the plain conv on the card's input
        with recorded_convs() as calls:
            e_r = res.pipeline.embed_cropped_batch(batches[1])
            torch.cuda.synchronize()
        if len(calls) != SITES_PER_FORWARD:
            raise AssertionError(f"residual: {len(calls)} int8 sites")
        for x, w, stride, pad, groups, got in calls:
            if not torch.equal(got, conv_s8_reference(x, w, stride, pad,
                                                      groups)):
                raise AssertionError(f"residual: site {tuple(x.shape)} -> "
                                     f"{tuple(got.shape)} differs from the "
                                     "plain conv")
        # -- drift from the f32 float embedder on the card
        f32 = FacePipeline(dataclasses.replace(
            cfg, rec_quantize=False, compute_dtype="float32"), params,
            device=device)
        e_f = f32.embed_cropped_batch(batches[1])
        del f32
        e_q = cal.pipeline.embed_cropped_batch(batches[1])
        if not np.isfinite(e_r).all() or e_r.shape != (8, DIM):
            raise AssertionError("residual embeddings not finite (8, 512)")
        drift_r = float((1 - (e_r * e_f).sum(-1)).max())
        drift_q = float((1 - (e_q * e_f).sum(-1)).max())
        if not drift_r < max(5 * drift_q, 2e-2):
            raise AssertionError(f"residual drift {drift_r} against "
                                 f"calibrated {drift_q}")

        # -- device ms and operations per forward, /recognize latency
        per_forward = {}
        for m, server in servers.items():
            net = server.pipeline.rec_net
            for b in CONV_BATCHES:
                xs = [rec_normalize(torch.tensor(rng.integers(
                    0, 256, (b, rh, rw, 3), dtype=np.uint8),
                    device=device).float()) for _ in range(2)]
                with torch.inference_mode():
                    ms = cuda_ms(net, [(x,) for x in xs], REMAINDER_REPS)
                    events = device_events(lambda: [
                        net(xs[i % 2]) for i in range(SPLIT_REPS)])
                busy = sum(us for _, _, us in events) / SPLIT_REPS / 1e3
                per_forward[f"{m}_b{b}"] = {
                    "back_to_back_ms": ms, "device_busy_ms": busy,
                    "device_ops": len(events) / SPLIT_REPS,
                    "conv_s8_kernels": sum("conv_s8" in e[0]
                                           for e in events) / SPLIT_REPS,
                    "idle_share": max(0.0, 1 - busy / ms)}
        snaps = {}
        for m, server in servers.items():
            if server is cal:
                for u in range(n):
                    cal.db.insert_user(f"u{u:02d}", f"U{u}")
                    cal.db.insert_face(f"u{u:02d}", f"c{u}.jpg",
                                       cal.pipeline.embed_cropped(crops[u]))
                cal.reload_gallery()
            snaps[m] = server.gallery.snapshot()
        lat = collections.defaultdict(list)
        for m in ("residual", "calibrated", "calibrated", "residual"):
            for b in CONV_BATCHES:
                for _ in range(REMAINDER_REPS + 1):
                    batch = rng.integers(0, 256, (b, rh, rw, 3), np.uint8)
                    t0 = time.perf_counter()
                    _, v, _ = servers[m].serving_embed(
                        servers[m].pad_batch(list(batch)), snaps[m])
                    v.cpu()
                    lat[f"{m}_b{b}"].append((time.perf_counter() - t0) * 1e3)
        # -- a residual engine pair at bucket 1, exported from this
        #    server's pipeline (the state stays outside the programs)
        eng_dir = os.path.join(tmp, "residual_engines")
        t0 = time.perf_counter()
        export_engines(res.pipeline, eng_dir, [1])
        export_s = time.perf_counter() - t0
    finally:
        for s in servers.values():
            s.close()
    del servers, res, cal

    # -- the engine pair served at bucket 1
    metas = {p: read_meta(os.path.join(eng_dir, f"{p}.fke"))
             for p in ("recognize", "embed")}
    if not all(m["rec_int8_residual"] and m["rec_calibrated"]
               for m in metas.values()):
        raise AssertionError(f"residual engine metadata: {metas}")
    eng_cfg = config("residual", server_batchBuckets=[1])
    t0 = time.perf_counter()
    server = FaceServer(eng_cfg, rec_params=params, device=device,
                        engines_dir=eng_dir)
    boot_s = time.perf_counter() - t0
    try:
        for u in range(4):
            server.db.insert_user(f"u{u}", f"U{u}")
            server.db.insert_face(f"u{u}", f"c{u}.jpg",
                                  server.pipeline.embed_cropped(crops[u]))
        server.reload_gallery()
        frame = rng.integers(0, 256, (1, *cfg.frame_hw, 3), np.uint8)
        runs = {}
        for mode in ("engines", "eager"):
            with (eager_serving(server) if mode == "eager"
                  else contextlib.nullcontext()):
                reset_launches()
                replies = (server.recognize_batch([crops[2]]),
                           server.inference_batch(list(frame)))
                snap = server.gallery.snapshot()
                outs = (server.serving_embed(crops[2:3], snap),
                        server.serving_recognize(frame, snap))
                torch.cuda.synchronize()
                runs[mode] = (replies, launches(), outs)
        (e_rep, e_cnt, e_out), (r_rep, r_cnt, r_out) = (runs["engines"],
                                                        runs["eager"])
        if e_cnt != r_cnt or e_cnt["conv_s8"] != 4 * SITES_PER_FORWARD:
            raise AssertionError(f"residual engine launches {e_cnt} "
                                 f"against eager {r_cnt}")
        _same_replies(e_rep[0], r_rep[0], "residual engine /recognize")
        _same_replies(e_rep[1], r_rep[1], "residual engine WS")
        if e_rep[0][0]["userId"] != "u2":
            raise AssertionError(f"residual engine: {e_rep[0]}")
        (emb_e, (res_e, *m_e)), (emb_r, (res_r, *m_r)) = e_out, r_out
        pairs = list(zip(emb_e, emb_r)) + list(zip(m_e, m_r)) + list(zip(
            res_e[:4] + (res_e.crops,), res_r[:4] + (res_r.crops,)))
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError("residual engine outputs differ from eager")
    finally:
        server.close()

    rec = {"phase": "server_remainder", "part": "int8_residual",
           "config": "configs/throughput.json + rec_calibrationDir + "
                     "rec_int8Residual",
           "users": n, "batches": [len(b) for b in batches],
           "forwards": forwards, "launches": counts,
           "sites_bit_equal": len(calls),
           "min_enrolled_similarity": min_sim,
           "cos_drift_vs_f32_card": {"residual": drift_r,
                                     "calibrated": drift_q},
           "per_forward": per_forward,
           "embed_match_ms": {k: statistics.median(v[1:])
                              for k, v in lat.items()},
           "engine": {"bucket": 1, "export_s": export_s, "boot_s": boot_s,
                      "rec_int8_residual": True, "bit_equal": True,
                      "launches": e_cnt}}
    emit(rec)
    return rec


def _face_landmarks(rng, n, nf, hw, device, big=None):
    """(n, nf, 5, 2) landmarks on the card: the ArcFace template rotated
    up to 60 degrees, scaled 0.6-1.5 (3.0 for the face ``big``, an (i, j)
    pair), placed anywhere in an (h, w) frame, with a little noise."""
    import torch

    from facekit_torch.ops.align import ARCFACE_TEMPLATE_112
    h, w = hw
    t = ARCFACE_TEMPLATE_112 - 56.0
    out = np.zeros((n, nf, 5, 2), np.float32)
    for i in range(n):
        for j in range(nf):
            a = np.deg2rad(rng.uniform(-60, 60))
            r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
            scale = 3.0 if (i, j) == big else rng.uniform(0.6, 1.5)
            out[i, j] = (t @ r.T * scale + rng.uniform((0, 0), (w, h))
                         + rng.normal(scale=0.7, size=(5, 2)))
    return torch.tensor(out, device=device)


def align_times(device, seed=15, n=8, nf=4):
    """ms per call (CUDA events, calls back to back), and the card's busy
    ms and operations per call from a trace, of the served alignment and
    crop at WS bucket 8's shape (8 frames of 480x640, 4 faces each):
    ``warp_align_frames`` with bf16 pass products, and ``crop_resize``
    (cubic, 112x112) of the landmarks' boxes. Calls only
    what every checkout with the alignment has, so it times an older one too
    (``--align``)."""
    import torch

    from facekit_torch.ops.align import warp_align_frames
    from facekit_torch.ops.resize import crop_resize

    rng = np.random.default_rng(seed)
    frames = torch.tensor(rng.integers(0, 256, (n, 480, 640, 3), np.uint8),
                          device=device)
    lms = _face_landmarks(rng, n, nf, (480, 640), device)
    boxes = torch.cat([lms.amin(-2) - 20.0, lms.amax(-2) + 20.0], -1)
    fns = {"warp_align_frames": lambda: warp_align_frames(
               frames, lms, dtype=torch.bfloat16),
           "crop_resize_cubic": lambda: crop_resize(
               frames.float(), boxes, (112, 112), "cubic")}
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = cuda_ms(fn, [()], 20)
        events = device_events(lambda: [fn() for _ in range(SPLIT_REPS)])
        out[f"{name}_device_ms"] = sum(
            us for _, _, us in events) / SPLIT_REPS / 1e3
        out[f"{name}_device_ops"] = len(events) / SPLIT_REPS
    return out


def _remainder_windowed(device, seed):
    """``warp_align_frames(slice_win=SLICE_WIN)`` on the card at N = 8
    frames of 480x640 with F = 4 faces each: bit-identical to the full
    path in f32 and in bf16 pass products, once with every face's window
    fitting (the windowed path) and once with one face too large (the
    whole batch on the full path); ms per call of each path (CUDA events
    around calls back to back; the windowed choice syncs once a call)."""
    import torch

    from facekit_torch.ops import align as A

    rng = np.random.default_rng(seed)
    n, nf, h, w = 8, 4, 480, 640
    frames = torch.tensor(rng.integers(0, 256, (n, h, w, 3), np.uint8),
                          device=device)

    rec = {"phase": "server_remainder", "part": "windowed_align",
           "frames": [n, h, w], "faces": nf, "slice_win": SLICE_WIN}
    tmpl = A._template((112, 112), device)
    for case, oversized in (("fitting", False), ("oversized", True)):
        lms = _face_landmarks(rng, n, nf, (h, w), device,
                              big=(5, 2) if oversized else None)
        boxes = A._window_box(lms, tmpl, 112, 112)
        side = float((boxes[..., 2] - boxes[..., 0]).max())
        if (side <= SLICE_WIN - 4) == oversized:
            raise AssertionError(f"windowed {case}: largest side {side}")
        for dtype in (torch.float32, torch.bfloat16):
            full = A.warp_align_frames(frames, lms, dtype=dtype)
            win = A.warp_align_frames(frames, lms, dtype=dtype,
                                      slice_win=SLICE_WIN)
            if not torch.equal(full, win):
                raise AssertionError(
                    f"windowed {case} {dtype}: differs from the full path "
                    f"by up to {float((full - win).abs().max())}")
        rec[f"{case}_largest_side"] = side
        for tag, sw in (("full", None), ("windowed", SLICE_WIN)):
            rec[f"{case}_{tag}_ms"] = cuda_ms(
                lambda: A.warp_align_frames(frames, lms, dtype=torch.bfloat16,
                                            slice_win=sw), [()], 10)
    rec["bit_identical"] = True
    rec["served"] = align_times(device)
    emit(rec)
    return rec


def call_trace(fn, arg, top=8):
    """One call ``fn(arg)`` (after one untimed) under ``torch.profiler``:
    host ms to its device sync, the device's busy ms (kernels and
    memsets), kernel launches, and the ``top`` host operations by total
    CPU time (name, calls, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(prof.key_averages(), key=lambda a: -a.cpu_time_total)
    return {"host_ms": host_ms,
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in device) / 1e3,
            "device_ops": len(device),
            "top": [[a.key, a.count, a.cpu_time_total / 1e3]
                    for a in rows[:top]]}


def main(argv) -> int:
    """No arguments: the whole smoke test. ``--searches``: the two search
    phases alone (build, ptxas, ``kernel_case``, ``kernel_int8_case``),
    for comparing search kernels; ``--convs``: the conv phase alone
    (build, ptxas, ``conv_s8_case``, ``conv_s8_forward``);
    ``--throughput``: the int8 embedder's forward and the throughput
    config's /recognize path alone (``int8_forward``,
    ``server_throughput``), for comparing them with another checkout;
    ``--gen``: the checkpoint-to-gallery phase alone (``weights_gen``);
    ``--detectors``: the conv's ``ptxas`` line and the detector paths
    alone (``server_detectors``, ``conv_s8_det_case``); ``--engines``:
    both shipped configs served from exported engines alone
    (``server_engines``, ``dispatch_cost``); ``--remainder``: the native
    pixel backend, the int8-residual embedder and the windowed alignment
    alone (``server_remainder``); ``--align``: the served alignment's and
    crop's ms alone (``align_times``), which runs on older checkouts too;
    ``--train``: training, its round trip to a server, and the 256-wide
    server alone (``train``). None of the nine prints an ``ok`` line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    repo_dir = os.path.dirname(os.path.abspath(__file__))
    import facekit_torch  # noqa: F401  (fails outside a checkout)
    from facekit_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    power = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": power,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    modes = {"--searches": ["cosine_topk", "cosine_topk_int8"],
             "--convs": ["conv_s8"],
             "--throughput": ["conv_s8", "cosine_topk_int8"],
             "--gen": ["cosine_topk", "ir_block"],
             "--detectors": ["conv_s8", "cosine_topk", "ir_block"],
             "--engines": None, "--remainder": None, "--align": [],
             "--train": ["cosine_topk", "ir_block"]}
    mode = argv[0] if len(argv) == 1 and argv[0] in modes else None
    if argv and mode is None:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    logs = _build.build(modes.get(mode), ptxas_verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs)})
    for name, text in logs.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)
    if mode == "--gen":
        phase_weights_gen("cuda", repo_dir, power)
        print(power, flush=True)
        return 0
    if mode == "--engines":
        phase_server_engines("cuda", repo_dir)
        print(power, flush=True)
        return 0
    if mode == "--train":
        phase_train("cuda", repo_dir, power)
        print(power, flush=True)
        return 0
    if mode == "--align":
        emit({"phase": "align_times", **align_times("cuda")})
        print(power, flush=True)
        return 0
    if mode == "--remainder":
        phase_server_remainder("cuda", repo_dir)
        print(power, flush=True)
        return 0
    if mode == "--detectors":
        emit({"phase": "ptxas", "kernel": "conv_s8",
              "kernels": conv_ptxas(logs)})
        phase_server_detectors("cuda", repo_dir)
        print(power, flush=True)
        return 0
    if mode == "--throughput":
        phase_int8_forward("cuda", repo_dir)
        phase_server_throughput("cuda", repo_dir)
        print(power, flush=True)
        return 0
    if mode == "--convs":
        emit({"phase": "ptxas", "kernel": "conv_s8",
              "kernels": conv_ptxas(logs)})
        conv_forwards(phase_conv("cuda"))
        print(power, flush=True)
        return 0
    emit({"phase": "ptxas", "kernel": "topk_partial_mma_kernel",
          "instantiations": mma_ptxas(logs)})
    emit({"phase": "ptxas", "kernel": "B <= 8 pass 1 and pass 2",
          "kernels": selection_ptxas(logs)})
    conv_regs = conv_ptxas(logs)
    if mode is None:
        emit({"phase": "ptxas", "kernel": "conv_s8", "kernels": conv_regs})

    max_err, timings = phase_kernels("cuda")
    if mode == "--searches":
        phase_int8_kernels("cuda")
        print(power, flush=True)
        return 0
    server = phase_server("cuda", repo_dir)
    int8_timings = phase_int8_kernels("cuda")
    big = phase_big_batches("cuda")
    convs = phase_conv("cuda")
    forwards = {f["batch"]: f for f in conv_forwards(convs)}
    int8_fwd = phase_int8_forward("cuda", repo_dir)
    tput = phase_server_throughput("cuda", repo_dir)
    blocks = phase_ir_block("cuda")
    inference = phase_server_inference("cuda", repo_dir)
    detectors, det_cases = phase_server_detectors("cuda", repo_dir)
    phase_weights_gen("cuda", repo_dir, power)
    engines, dispatch = phase_server_engines("cuda", repo_dir)
    native_path, residual_path, _ = phase_server_remainder("cuda", repo_dir)
    phase_train("cuda", repo_dir, power)
    # each kernel's launches on the engine-served paths, per config, and
    # on server_remainder's native-pixels (both servers) and residual paths
    engine_launches = {e["config"]: e["launches"] for e in engines}
    native_launches = native_path.get("launches")

    def on_engines(name):
        out = {"engine_launches": {c: n[name]
                                   for c, n in engine_launches.items()}}
        if name in ("cosine_topk", "ir_block"):
            out["native_pixels_launches"] = (
                None if native_launches is None else
                {hp: n[name] for hp, n in native_launches.items()})
        else:
            out["residual_launches"] = residual_path["launches"][name]
        return out

    main_case = next(t for t in timings if t["dtype"] == "bfloat16"
                     and t["B"] == 8 and t["k"] == 1)
    int8_case = next(t for t in int8_timings if t["B"] == 64 and t["k"] == 1)
    k4_case = next(c for c in convs if c["launches_per_forward"] == 0)
    k4 = k4_case["shape"]
    conv64 = forwards[64]
    # kernel #3 at the main path's shapes: one bf16 IR-50 forward of 8
    # crops runs its 20 identity blocks at the four shapes
    b8 = [c for c in blocks if c["dtype"] == "bfloat16"
          and c["shape"]["N"] == 8]

    def per_forward(key, dtype="bfloat16", n=8):
        return sum(c[key] * c["blocks_per_forward"] for c in blocks
                   if c["dtype"] == dtype and c["shape"]["N"] == n)
    emit({"kernels": [{
        "name": "cosine_topk", "route": "cuda",
        "source": "facekit_torch/ops/csrc/cosine_topk.cu",
        "replaces": "facekit/ops/similarity.py:275",
        "launches": inference["launches"]["cosine_topk"],
        "max_abs_err": max(max_err, server["max_abs_err"]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": f"bf16 N={main_case['N']} count={main_case['count']} "
                 "B=8 k=1",
        "tensor_core_cases": [
            {key: t[key] for key in ("B", "k", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
            for t in timings if t["dtype"] == "bfloat16"
            and (t["B"], t["k"]) in ((256, 1), (256, 64), (32, 1))],
        "f32_tensor_core_cases": [
            {key: t[key] for key in ("B", "k", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "err_vs_f64",
                                     "library_err_vs_f64")}
            for t in timings if t["dtype"] == "float32"
            and t["B"] in (32, 256)],
        "small_batch_k64_cases": [
            {key: t[key] for key in SMALL_BATCH_KEYS}
            for t in timings if t["B"] <= 8 and t["k"] == 64],
        "big_batch_cases": [
            {key: c[key] for key in ("dtype", "B", "k", "ms", "bound_ms",
                                     "max_abs_err")}
            for c in big if c["dtype"] != "int8"],
        **on_engines("cosine_topk")}, {
        "name": "cosine_topk_int8", "route": "cuda",
        "source": "facekit_torch/ops/csrc/cosine_topk_int8.cu",
        "replaces": "facekit/ops/similarity.py:183",
        "launches": tput[0]["launches"]["cosine_topk_int8"],
        "max_abs_err": 0.0,
        "ms": int8_case["ms"], "plain_ms": int8_case["plain_ms"],
        "bound_ms": int8_case["bound_ms"], "bound_by": int8_case["bound_by"],
        "library_ms": int8_case["library_ms"],
        "library_call": int8_case["library_call"],
        "shape": f"int8 N={int8_case['N']} count={int8_case['count']} "
                 "B=64 k=1",
        "tensor_core_cases": [
            {key: t[key] for key in ("B", "k", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
            for t in int8_timings if t["B"] in (64, 256)],
        "small_batch_k64_cases": [
            {key: t[key] for key in SMALL_BATCH_KEYS if key in t}
            for t in int8_timings if t["B"] <= 8 and t["k"] == 64],
        "big_batch_cases": [
            {key: c[key] for key in ("B", "k", "ms", "bound_ms")}
            for c in big if c["dtype"] == "int8"],
        **on_engines("cosine_topk_int8")}, {
        "name": "conv_s8", "route": "cuda",
        "source": "facekit_torch/ops/csrc/conv_s8.cu",
        "replaces": "docs/experiments/pallas_s8_stride2_conv.py:86",
        "launches": tput[0]["launches"]["conv_s8"],
        "max_abs_err": 0,
        "ms": conv64["ms"], "plain_ms": conv64["plain_ms"],
        "bound_ms": conv64["bound_ms"],
        "bound_by": ("operations" if all(
            c["bound_by"] == "operations" for c in convs
            if c["batch"] == 64 and c["launches_per_forward"])
            else "bytes"),
        "library_ms": None,
        "library_note": "PyTorch has no s8 convolution on CUDA; "
                        "bf16_cudnn_ms is cuDNN's bf16 F.conv2d at the "
                        "same shapes, as a yardstick",
        "bf16_cudnn_ms": conv64["bf16_cudnn_ms"],
        "shape": "s8: the 52 conv sites of one int8 IR-50 forward of 64 "
                 "crops, times summed",
        "launches_per_forward": SITES_PER_FORWARD,
        "per_forward": [
            {key: f[key] for key in ("batch", "ms", "host_ms", "device_ms",
                                     "bound_ms", "plain_ms", "bf16_cudnn_ms",
                                     "bf16_cudnn_device_ms",
                                     "sites_by_route")}
            for f in forwards.values()],
        "in_forward": [
            {key: f[key] for key in ("batch", "back_to_back_ms",
                                     "conv_s8_kernels_per_forward",
                                     "conv_s8_device_ms",
                                     "memsets_per_forward",
                                     "device_ops_per_forward",
                                     "device_busy_ms", "idle_share")}
            for f in int8_fwd],
        "routes": [{**c["shape"], "route": c["route"], "plan": c["plan"],
                    "sites": c["launches_per_forward"]}
                   for c in convs if c["launches_per_forward"]],
        "kernel4_case": {
            key: k4_case[key] for key in ("ms", "device_us", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "bf16_cudnn_ms", "route")}
        | {"shape": f"s8 N={k4['N']} {k4['H']}x{k4['W']}x{k4['C']} -> "
                    f"{k4['O']}, 3x3 stride 2 pad 1"},
        # the detector paths: launches on each served path, the
        # detector's device ms per forward and conv_s8's share, and the
        # int8 sites of one detector forward summed per path and bucket
        "detector_paths": [
            {key: d[key] for key in d if key.startswith(
                ("path", "launches", "det_device_ms", "bf16_det_device_ms",
                 "conv_s8_share", "inference_ms"))}
            for d in detectors],
        "detector_sites": det_case_sums(det_cases),
        # registers, stack and spill of each route's kernels, the
        # depthwise one among them
        "ptxas": conv_regs, **on_engines("conv_s8"),
        "registered_op": dispatch["conv_s8"]}, {
        "name": "ir_block", "route": "cuda",
        "source": "facekit_torch/ops/csrc/ir_block.cu",
        "replaces": "docs/experiments/fused_block_kernel.py:84",
        "launches": inference["launches"]["ir_block"],
        "max_abs_err": max(c["max_abs_err"] for c in blocks),
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": ("operations" if all(c["bound_by"] == "operations"
                                         for c in b8) else "bytes"),
        "library_ms": None,
        "library_note": "no PyTorch call computes the fused block; eager_ms "
                        "is the block op by op (cuDNN convs), as the port "
                        "ran it before this kernel",
        "eager_ms": per_forward("eager_ms"),
        "shape": "bf16 N=8: the 20 identity blocks of one IR-50 forward "
                 "(2 x 56x56x64, 3 x 28x28x128, 13 x 14x14x256, "
                 "2 x 7x7x512), times summed",
        # the f32 path (CUDA cores) per forward; no shipped config
        # computes in f32, so the served paths launch it no time
        "f32_per_forward": [
            {"batch": n, **{key: per_forward(key, "float32", n)
                            for key in ("ms", "plain_ms", "eager_ms",
                                        "bound_ms")}}
            for n in IR_BLOCK_BATCHES["float32"]],
        **on_engines("ir_block"), "registered_op": dispatch["ir_block"]}]})
    print(power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
