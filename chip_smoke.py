#!/usr/bin/env python3
"""Smoke test of facekit_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version at the top gallery bucket (N = 1,048,576), then
drives the server's /recognize + enrollment path of configs/default.json
(IR-50, bf16) on the card and checks what comes out. Prints one JSON line
per phase, the ``kernels`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero; nothing falls back to the CPU or to a plain version. Without
CUDA it exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_TOP = 1 << 20          # top bucket of the default gallery ladder
DIM = 512
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,               # tensor cores, dense
            "float32": 67e12}                 # outside the tensor cores
SCORE_ATOL = 1e-4        # f32 sums over D=512 in another order
COS_DIST_MAX = 1e-3      # bf16 embeddings vs f32 (BASELINE.json north star)


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


def search_bound(n_rows: int, b: int, k: int, dtype: str):
    """Least time (ms) for one search on an H100 SXM and what bounds it:
    the gallery rows the search needs and the queries read once, the
    outputs written once; 2*B*rows*D operations at the dtype's peak."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = n_rows * DIM * item + b * DIM * item + b * k * 8
    ops = 2 * b * n_rows * DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def phase_kernels(device, n=N_TOP, seed=0):
    """The search kernel against its plain version at N rows."""
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
        for b in (1, 8, 256):
            for k in (1, 64):
                qs = [unit_rows(b, g.dtype) for _ in range(4)]
                tag = f"{dname} B={b} k={k}"
                err = check_search(tag, cosine_topk(g, qs[0], count, k),
                                   cosine_topk_reference(g, qs[0], count,
                                                         k + 1), k)
                max_err = max(max_err, err)
                args = [(g, q, count, k) for q in qs]
                bound, by = search_bound(min(n, count + k), b, k, dname)
                rec = {"phase": "kernel_case", "dtype": dname, "N": n,
                       "count": count, "B": b, "k": k, "max_abs_err": err,
                       "ms": cuda_ms(cosine_topk, args, 20),
                       "plain_ms": cuda_ms(cosine_topk_reference, args, 3),
                       "library_ms": cuda_ms(
                           lambda g_, q_, c_, k_: torch.topk(q_ @ g_[:c_].T,
                                                             k_),
                           args, 10),
                       "bound_ms": bound, "bound_by": by}
                emit(rec)
                timings.append(rec)

        # the query tiles the timed batches do not reach (2 and 4 queries)
        for b in (2, 3):
            q = unit_rows(b, g.dtype)
            max_err = max(max_err, check_search(
                f"{dname} B={b} k=5", cosine_topk(g, q, count, 5),
                cosine_topk_reference(g, q, count, 6), 5))

        # ties: row j duplicates row i < j and the query is that row, so
        # the two equal top scores must come back lower index first
        b = 8
        lo = torch.arange(b, device=device) * (n // (2 * b)) + 17
        hi = lo + n // 2
        gt = g.clone()
        gt[hi] = gt[lo]
        v, i = cosine_topk(gt, gt[lo].contiguous(), n, 2)
        i = i.cpu().numpy()
        if not (np.array_equal(i[:, 0], lo.cpu().numpy())
                and np.array_equal(i[:, 1], hi.cpu().numpy())
                and torch.equal(v[:, 0], v[:, 1])):
            raise AssertionError(f"{dname} ties: got {i.tolist()}")
        del gt

        # k > count: the masked padding rows follow in ascending order
        q = unit_rows(8, g.dtype)
        kern = cosine_topk(g, q, 3, 8)
        max_err = max(max_err, check_search(
            f"{dname} k>count", kern, cosine_topk_reference(g, q, 3, 9), 8))
        if not np.array_equal(np.sort(kern[1].cpu().numpy()[:, :3], 1),
                              np.tile(np.arange(3), (8, 1))) or \
                not np.array_equal(kern[1].cpu().numpy()[:, 3:],
                                   np.tile(np.arange(3, 8), (8, 1))):
            raise AssertionError(f"{dname} k>count: {kern[1].tolist()}")
    torch.cuda.synchronize()
    return max_err, timings


def phase_server(device, repo_dir, seed=1, n_users=32):
    """configs/default.json's /recognize + enrollment path on the card."""
    import torch

    from facekit_torch.config import load_config
    from facekit_torch.ops.similarity import (cosine_topk,
                                              cosine_topk_reference)
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
            cosine_topk.launches = 0
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
            launches = cosine_topk.launches
            if launches < 2:
                raise AssertionError(f"search kernel launched {launches} "
                                     "times on the /recognize path")

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

            # -- embed+match latency at each batch bucket
            def embed_match_ms(b, reps=20):
                ts = []
                for r in range(reps):
                    batch = rng.integers(0, 256, (b, rh, rw, 3), np.uint8)
                    t0 = time.perf_counter()
                    _, v, _ = server.serving_embed(server.pad_batch(
                        list(batch)), snap)
                    v.cpu()
                    ts.append((time.perf_counter() - t0) * 1e3)
                return statistics.median(ts[2:])
            rec = {"phase": "server", "config": "configs/default.json",
                   "network": cfg.rec_network, "dtype": cfg.compute_dtype,
                   "users": n_users, "requests": len(queries),
                   "gallery_capacity": server.gallery.capacity,
                   "launches": launches, "max_abs_err": err,
                   "cos_dist_vs_f32_cpu": cos_dist,
                   "min_enrolled_similarity": float(sims[:4].min()),
                   "embed_match_ms_b1": embed_match_ms(1),
                   "embed_match_ms_b8": embed_match_ms(8)}
            emit(rec)
            return rec
        finally:
            server.close()


def main() -> int:
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

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs)})
    for name, text in logs.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)

    max_err, timings = phase_kernels("cuda")
    server = phase_server("cuda", repo_dir)
    main_case = next(t for t in timings if t["dtype"] == "bfloat16"
                     and t["B"] == 8 and t["k"] == 1)
    emit({"kernels": [{
        "name": "cosine_topk", "route": "cuda",
        "source": "facekit_torch/ops/csrc/cosine_topk.cu",
        "replaces": "facekit/ops/similarity.py:275",
        "launches": server["launches"],
        "max_abs_err": max(max_err, server["max_abs_err"]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": f"bf16 N={main_case['N']} count={main_case['count']} "
                 "B=8 k=1"}]})
    print(power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
