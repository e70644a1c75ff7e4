"""The build helpers of the port and the phase profiler's source rewrite,
which need neither nvcc nor a card."""

import importlib.util
import os

import pytest

from sigmarl_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _phases_module():
    path = os.path.join(ROOT, "scripts", "profile_qp_phases.py")
    spec = importlib.util.spec_from_file_location("profile_qp_phases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_swapped_library_swaps_one_name_and_restores():
    real = build.library
    fake = object()
    with build.swapped_library("qp_newton", fake):
        assert build.library("qp_newton") is fake
    assert build.library is real
    with pytest.raises(KeyError):
        with build.swapped_library("qp_newton", fake):
            raise KeyError("inside")
    assert build.library is real


def test_phase_profiler_instruments_every_marker():
    """Each `// ---- <phase>` marker of the solve kernel gets one stamp, the
    kernel its start and end, and a source without markers is refused."""
    prof = _phases_module()
    with open(os.path.join(build.CSRC, build.SOURCES["qp_newton"])) as f:
        src = f.read()
    markers = sum(1 for ln in src.splitlines() if prof._MARK.match(ln))
    text, names = prof.instrument(src)
    assert markers > 1 and len(names) == markers + 1 and names[0] == "kernel total"
    assert text.count("__qp_total(false);") == text.count("__qp_total(true);") >= 1
    assert "qp_prof_read" in text and "__qp_stamp(-1);" in text
    plain = "\n".join(ln for ln in src.splitlines() if not prof._MARK.match(ln))
    with pytest.raises(ValueError, match="no phase markers"):
        prof.instrument(plain)
