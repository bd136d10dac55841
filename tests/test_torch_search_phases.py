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


def test_checkout_is_the_wgmma_form():
    assert sp.form_of(CSRC) is sp._WGMMA


@pytest.mark.parametrize("name", ["topk_wgmma.cuh", "topk_mma.cuh",
                                  "cosine_topk.cu", "cosine_topk_int8.cu"])
def test_kernels_carry_no_timing_code(name):
    """The timers live only in the copy the phase split builds."""
    text = (CSRC / name).read_text()
    assert "globaltimer" not in text and "clock64" not in text
    assert "PH(" not in text and "g_stamps" not in text


def test_stamped_header_marks_every_phase_once_a_boundary():
    src = (CSRC / "topk_wgmma.cuh").read_text()
    out = sp.stamped_header(src, sp._WGMMA)
    kernel = out[out.index("topk_partial_wgmma_kernel("):]
    marks = [int(m) for m in re.findall(r"PH\((\d)\);", kernel)]
    # every phase of the wgmma form is marked; the warpgroup's and the
    # selection warp's recorders both end
    assert sorted(set(marks)) == list(range(len(sp.PHASES)))
    assert kernel.count("PH_END(0);") == 1 and kernel.count("PH_END(1);") == 1
    assert kernel.count("PH_BEGIN(") == 1
    # the original text is all there, in order
    assert re.sub(r"\s*PH(?:_BEGIN|_END)?\([^\n]*\n", "\n", out).count(
        "mbar_wait(full + 8 * slot, phase);") == 1
    assert f"#define SLOTS_ {sp.SLOTS}" in out


def test_refuses_a_source_of_neither_form(tmp_path):
    (tmp_path / "topk_mma.cuh").write_text("// an f32-only pass 1\n")
    with pytest.raises(ValueError, match="neither"):
        sp.form_of(tmp_path)
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
