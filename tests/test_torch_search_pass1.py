"""The searches' tensor-core pass 1 at B > 8, checked on the CPU.

``pass1_layout`` (``facekit_torch/ops/similarity.py``) mirrors how
``topk_wgmma.cuh``'s ``WgTile`` lays out a CTA's shared memory for each
operand type; it is held here to the numbers the kernel's source
``static_assert``s, to the card's 232,448 bytes and to the 1,024-byte
alignment of the swizzled operands. A numpy model of the f32 kernel's
sums (3xTF32: each operand split into a tf32 hi and lo, the products
lo*hi, hi*lo, hi*hi of each k8 step in the kernel's K order, the tensor
cores rounding toward zero as they accumulate, a fresh accumulator a
stage, the stages added to nearest) is held to float64. The kernel itself
is in tests/test_torch_kernels.py. Imports neither JAX nor facekit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from facekit_torch.ops import similarity as sim
from facekit_torch.ops.similarity import (DIM, MMA_QUERIES, MMA_QUERIES_F32,
                                          MMA_ROWS, PASS1_ALIGN,
                                          PASS1_BARRIERS, PASS1_MAX_STAGES,
                                          PASS1_SMEM, PASS1_STAGE,
                                          pass1_layout)

CSRC = Path(sim.__file__).resolve().parent / "csrc"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
CTYPES = {"float": "float32", "uint16_t": "bfloat16", "int8_t": "int8"}
REGIONS = ["queries", "ring", "scores", "lists", "buffers", "fills",
           "barriers"]
KS = [1, 2, 5, 32, 64]
# the ring at each k: what is left of 232,448 bytes in stages of 16 KB
RINGS = {"float32": {1: 4, 2: 4, 5: 4, 32: 4, 64: 3},
         "bfloat16": {1: 6, 2: 5, 5: 5, 32: 4, 64: 3},
         "int8": {1: 8, 2: 7, 5: 7, 32: 6, 64: 5}}


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("k", KS)
def test_pass1_layout_fits_and_aligns(kind, k):
    lay = pass1_layout(DTYPES[kind], k)
    per_cta = MMA_QUERIES_F32 if kind == "float32" else MMA_QUERIES
    row = DIM * DTYPES[kind].itemsize
    want = {"queries": (2 if kind == "float32" else 1) * per_cta * row,
            "ring": RINGS[kind][k] * PASS1_STAGE,
            # two score tiles; one in f32 at k > 1, for a deeper ring
            "scores": (1 if kind == "float32" and k > 1 else 2)
            * per_cta * MMA_ROWS * 4,
            "lists": per_cta * k * 8,
            "buffers": per_cta * 32 * 8 if k > 1 else 0,
            "fills": per_cta * 4,
            "barriers": PASS1_BARRIERS}
    assert {r: lay[r][1] for r in REGIONS} == want
    # regions back to back from the aligned base, in this order
    at = 0
    for r in REGIONS:
        assert lay[r][0] == at
        at += lay[r][1]
    assert lay["total"] == at <= PASS1_SMEM
    assert lay["stages"] == RINGS[kind][k] <= PASS1_MAX_STAGES
    # one stage more would not fit (below the ring's cap of 8)
    if lay["stages"] < PASS1_MAX_STAGES:
        assert lay["total"] + PASS1_STAGE > PASS1_SMEM
    # the swizzled operands (query blocks, stages) on 1,024-byte bounds
    assert lay["queries"][0] % PASS1_ALIGN == 0
    assert lay["ring"][0] % PASS1_ALIGN == 0
    assert PASS1_STAGE % PASS1_ALIGN == 0
    assert per_cta * 128 % PASS1_ALIGN == 0          # a query block
    if kind == "float32":                             # the lo tile
        assert lay["queries"][1] // 2 % PASS1_ALIGN == 0
    # the score tiles and lists 16-byte aligned, the barriers 8
    assert lay["scores"][0] % 16 == 0 and lay["barriers"][0] % 8 == 0


def _asserted(ctype):
    """{expression: value} of the ``WgTile<ctype>`` numbers that
    topk_wgmma.cuh static_asserts, e.g. {"nst(KMAX)": 2}."""
    src = (CSRC / "topk_wgmma.cuh").read_text()
    pat = rf"WgTile<{re.escape(ctype)}>::(\w+(?:\(\w+\))?) == (\d+)"
    return {m[0]: int(m[1]) for m in re.findall(pat, src)}


@pytest.mark.parametrize("ctype", list(CTYPES))
def test_pass1_layout_is_the_kernels(ctype):
    """Every number the kernel static_asserts of its layout, from the
    mirror."""
    kind = CTYPES[ctype]
    got = _asserted(ctype)
    assert got, f"no static_assert of WgTile<{ctype}> in topk_wgmma.cuh"
    for expr, value in got.items():
        name, _, arg = expr.partition("(")
        k = {"KMAX": 64}.get(arg.rstrip(")"), None) or \
            int(arg.rstrip(")") or 1)
        lay = pass1_layout(DTYPES[kind], k)
        mirror = {"Q_BYTES": lay["queries"][1],
                  "SCORES": pass1_layout(DTYPES[kind], 1)["scores"][1] // 2,
                  "nst": lay["stages"],
                  "smem": lay["total"],
                  "rest": lay["total"] - lay["queries"][1] - lay["ring"][1]}
        assert mirror[name] == value, (expr, mirror[name], value)


# -- the f32 kernel's sums ----------------------------------------------

def _tf32(x):
    """What the tensor cores read of an f32: its top 19 bits."""
    return (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)


def _split(x):
    """split_tf32 (mma_bf16.cuh): hi = x rounded to 11 significant bits
    by Veltkamp's split in f32, lo = x - hi."""
    t = (x * np.float32(8193.0)).astype(np.float32)
    hi = (t - (t - x).astype(np.float32)).astype(np.float32)
    return hi, (x - hi).astype(np.float32)


def _rz(x):
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _k_order():
    """The K of each k8 step, in the kernel's order: stage s (32 floats),
    step kk, column c holds element 8 (c % 4) + 2 kk + c / 4 of the
    stage (a thread's two 16-byte loads of a row hold its eight values)."""
    return [[32 * s + 8 * (c % 4) + 2 * kk + c // 4 for c in range(8)]
            for s in range(DIM // 32) for kk in range(4)]


def _kernel_sums(g, q, staged=True):
    """The f32 pass 1's scores of pairs (g[i], q[i]): per k8 step the
    three products summed into the accumulator, rounded toward zero; a
    fresh accumulator each stage of 4 steps, added to the score rounded
    to nearest (``staged``), or one accumulator over all 64 steps."""
    gh, gl = _split(g)
    qh, ql = _split(q)
    gh, gl, qh, ql = (_tf32(a).astype(np.float64) for a in (gh, gl, qh, ql))
    score = np.zeros(len(g), np.float32)
    acc = np.zeros(len(g), np.float32)
    for step, cols in enumerate(_k_order()):
        if staged and step % 4 == 0:
            acc = np.zeros(len(g), np.float32)
        for a, b in ((gl, qh), (gh, ql), (gh, qh)):
            acc = _rz(acc.astype(np.float64)
                      + (a[:, cols] * b[:, cols]).sum(1))
        if staged and step % 4 == 3:
            score = (score + acc).astype(np.float32)
    return score if staged else acc


def test_kernel_k_order_covers_each_element_once():
    order = np.array(_k_order())
    assert order.shape == (DIM // 8, 8)
    assert sorted(order.ravel()) == list(range(DIM))
    # a thread (column c % 4) reads elements 8 (c % 4) .. + 7 of a stage
    # over its four steps: two 16-byte loads a row
    for c in range(4):
        got = sorted(order[:4, c].tolist() + order[:4, c + 4].tolist())
        assert got == list(range(8 * c, 8 * c + 8))


@pytest.mark.parametrize("pairs", ["random", "near", "same"])
def test_3xtf32_stage_sums_within_the_bar(pairs):
    """2,000 seeded unit pairs at D = 512: random (scores near 0), a row
    and a noisy copy of it (near 0.98), a row and itself (1). With a
    fresh accumulator a stage the scores stay more than 10x under the
    plain version's 1e-5 bar; one accumulator over all 64 steps drifts
    at least 5x as far (for matching pairs past 2e-6: the drift that
    reorders near-tied rows)."""
    rng = np.random.default_rng({"random": 1, "near": 2, "same": 3}[pairs])
    g = rng.normal(size=(2000, DIM))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = {"random": rng.normal(size=g.shape),
         "near": g + 0.02 * rng.normal(size=g.shape), "same": g}[pairs]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    g, q = g.astype(np.float32), q.astype(np.float32)
    exact = (g.astype(np.float64) * q.astype(np.float64)).sum(1)
    staged = np.abs(_kernel_sums(g, q) - exact).max()
    chain = np.abs(_kernel_sums(g, q, staged=False) - exact).max()
    assert staged < 1e-6
    assert chain > 5 * staged
    if pairs != "random":
        assert chain > 2e-6
