"""The int8 RetinaFace cases of two tests of test_torch_int8_detector.py,
the slowest of that file, in a file of their own so that ``--dist
loadfile`` gives them another worker: every int8 site against facekit's
s8 conv on its own input, and batch invariance. Same checks, inputs and
bars, torch's CPU ops in one thread (the functions and the fixture are
that file's)."""

import pytest

from test_torch_int8_detector import (_Family, every_site_equals_facekit,
                                      int8_detector_is_batch_invariant,
                                      one_thread)  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["mobilenet0.25"])
def fam(request):
    return _Family(request.param)


def test_every_site_equals_facekit_on_its_inputs(fam, monkeypatch):
    """``every_site_equals_facekit`` on int8 RetinaFace (47 sites, 13
    depthwise)."""
    every_site_equals_facekit(fam, monkeypatch)


def test_int8_detector_is_batch_invariant(fam, monkeypatch):
    """``int8_detector_is_batch_invariant`` on int8 RetinaFace, its whole
    detector bit for bit."""
    int8_detector_is_batch_invariant(fam, monkeypatch)
