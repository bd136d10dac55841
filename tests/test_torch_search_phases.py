"""The searches' pass-1 phase split (``python -m
facekit_torch.ops.search_phases``): the timed copy of the kernel's source,
checked on the CPU; the timing itself needs a card. Imports neither JAX
nor facekit.
"""

import re
from pathlib import Path

import pytest

from facekit_torch.ops import search_phases as sp

CSRC = Path(sp.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("dtype", sp.DTYPES)
def test_checkout_is_the_wgmma_form(dtype):
    """Every type's pass 1 at B > 8 is the one wgmma kernel."""
    assert sp.form_of(CSRC, dtype) is sp._WGMMA


@pytest.mark.parametrize("name", ["topk_wgmma.cuh", "hopper.cuh",
                                  "mma_bf16.cuh", "topk_fold.cuh",
                                  "cosine_topk.cu", "cosine_topk_int8.cu"])
def test_kernels_carry_no_timing_code(name):
    """The timers live only in the copy the phase split builds."""
    text = (CSRC / name).read_text()
    assert "globaltimer" not in text and "clock64" not in text
    assert "PH(" not in text and "g_stamps" not in text


def _marks(text):
    return [int(m) for m in re.findall(r"PH\((\d)\);", text)]


def test_stamped_header_marks_every_phase_once_a_boundary():
    src = (CSRC / "topk_wgmma.cuh").read_text()
    out = sp.stamped_header(src, sp._WGMMA)
    kernel = out[out.index("topk_partial_wgmma_kernel("):]
    # every phase of the wgmma form is marked; the warpgroups' and the
    # selection warp's recorders both end
    assert sorted(set(_marks(kernel))) == list(range(len(sp.PHASES)))
    assert kernel.count("PH_END(0);") == 1 and kernel.count("PH_END(1);") == 1
    assert kernel.count("PH_BEGIN(") == 1
    # the original text is all there, in order
    assert re.sub(r"\s*PH(?:_BEGIN|_END)?\([^\n]*\n", "\n", out).count(
        "mbar_wait(full + 8 * slot, phase);") == 2
    assert f"#define SLOTS_ {sp.SLOTS}" in out


def test_f32_form_marks_each_phase_once():
    """The f32 branch (A fragments from registers) marks its stage wait
    and its products once each; the score-tile hand-off and the
    selection, which every type shares, mark theirs once."""
    out = sp.stamped_header((CSRC / "topk_wgmma.cuh").read_text(), sp._WGMMA)
    kernel = out[out.index("topk_partial_wgmma_kernel("):]
    f32 = kernel[kernel.index("if constexpr (P::F32) {"):
                 kernel.index("    } else {\n      // lane l of warp w")]
    assert sorted(_marks(f32[f32.index("auto stage"):])) == [1, 2]
    shared = kernel[:kernel.index("if constexpr (P::F32) {")]
    assert sorted(_marks(shared[shared.index("auto score_tile"):])) == [2, 3, 4]
    selection = kernel[kernel.index("// the selection warps: warp sw"):]
    assert sorted(_marks(selection)) == [5, 6, 6, 6]
    # the recorders: the first warpgroup's thread 0 and the first
    # selection warp's lane 0, whatever the warpgroups' width
    assert "threadIdx.x == P::MMA_THREADS" in kernel


def test_refuses_a_source_of_neither_form(tmp_path):
    (tmp_path / "topk_mma.cuh").write_text("// an f32-only pass 1\n")
    for dtype in sp.DTYPES:
        with pytest.raises(ValueError, match="neither"):
            sp.form_of(tmp_path, dtype)
    with pytest.raises(ValueError, match="anchor"):
        sp.stamped_header("namespace {\nvoid topk_partial_wgmma_kernel() {}\n",
                          sp._WGMMA)


def test_mma_sync_form_is_recognised_by_its_template(tmp_path):
    """The kernel the wgmma one replaced: one template over the three
    operand types with mma_step; its anchors all lie in a kernel of that
    shape."""
    fake = ("namespace {\n"
            "template <typename T>\n__global__ void\n"
            "topk_partial_mma_kernel(int x) {\n"
            + "".join(a for a, _, _ in sp._MMA_SYNC[2])
            + "  mma_step(acc[i][j], a, b);\n}\n}\n")
    (tmp_path / "topk_mma.cuh").write_text(fake)
    assert sp.form_of(tmp_path) is sp._MMA_SYNC
    out = sp.stamped_header(fake, sp._MMA_SYNC)
    marks = {int(m) for m in re.findall(r"PH\((\d)\);", out)}
    assert marks == {0, 1, 2, 3, 4, 6}
    assert out.count("PH_END(0);") == 1


def _f32_only(tmp_path):
    """A source whose bf16 and s8 pass 1 is the wgmma kernel of those two
    types and whose f32 pass 1 is the f32-only 3xTF32 mma.sync kernel
    (MmaTile, no template), each carrying its form's anchors."""
    mma = ("namespace {\nstruct MmaTile {};\n__global__ void\n"
           "topk_partial_mma_kernel(int x) {\n"
           + "".join(a for a, _, _ in sp._MMA_F32[2]) + "}\n}\n")
    wg = ("namespace {\ntemplate <typename T>\n__global__ void\n"
          "topk_partial_wgmma_kernel(int x) {\n"
          + "".join(a for a, _, _ in sp._WGMMA_BF16_S8[2]) + "}\n}\n")
    (tmp_path / "topk_mma.cuh").write_text(mma)
    (tmp_path / "topk_wgmma.cuh").write_text(wg)
    return mma, wg


def test_f32_only_mma_sync_form_is_recognised_by_its_text(tmp_path):
    """The f32 pass 1 that the wgmma kernel of all three types replaced:
    thread 0 marks each phase in turn, as in the templated form."""
    mma, _ = _f32_only(tmp_path)
    assert sp.form_of(tmp_path, "float32") is sp._MMA_F32
    out = sp.stamped_header(mma, sp._MMA_F32)
    assert set(_marks(out)) == {0, 1, 2, 3, 4, 6}
    assert out.count("PH_BEGIN(threadIdx.x == 0)") == 1
    assert out.count("PH_END(0);") == 1


@pytest.mark.parametrize("dtype,form", [("bfloat16", "_WGMMA_BF16_S8"),
                                        ("int8", "_WGMMA_BF16_S8"),
                                        ("float32", "_MMA_F32")])
def test_forms_by_type_in_one_source(tmp_path, dtype, form):
    """Each type gets the form of the kernel it runs; the timers of two
    stamped headers of one library are defined once."""
    _, wg = _f32_only(tmp_path)
    assert sp.form_of(tmp_path, dtype) is getattr(sp, form)
    both = (sp.stamped_header(wg, sp._WGMMA_BF16_S8)
            + sp.stamped_header((tmp_path / "topk_mma.cuh").read_text(),
                                sp._MMA_F32))
    assert both.count("#ifndef FACEKIT_PH_TIMERS") == 2
    assert both.count("#define FACEKIT_PH_TIMERS") == 2
