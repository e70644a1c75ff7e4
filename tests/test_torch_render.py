"""Host-side rendering of the port against the JAX package: `render_frame`
draws the same pixels from the same record (Agg backend, same figure size
and DPI: RGBA buffers equal exactly), `save_rollout_video` writes one frame
per step (read back with OpenCV), `render_footprints` writes its figure,
the colour tables are the JAX package's, and `core/geometry.py::interx`
agrees with its numpy oracle `utils/interx_numpy.py` (exactly, as booleans).
The `--save_video` flags of `main_testing` and `main_eval` are tested with
those entry points in `test_torch_eval.py`."""

import os

import numpy as np
import pytest
import torch

from sigmarl_tpu import colors as jcolors
from sigmarl_tpu import render as jrender
from sigmarl_tpu_torch import colors, render
from sigmarl_tpu_torch.core.geometry import interx
from sigmarl_tpu_torch.utils.interx_numpy import interx_bool, interx_points

torch.set_num_threads(1)
T, B, N = 3, 2, 4


def _record(seed=0):
    """A small rollout record on cpm_mixed: poses on the map, actions and
    the priority lines of XP-MARL."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform([0.5, 0.5], [4.0, 3.5], (B, N, 2)) for _ in range(T)])
    return {
        "pos": pos.astype(np.float32),
        "rot": rng.uniform(-3, 3, (T, B, N)).astype(np.float32),
        "applied_action": rng.uniform(0, 1, (T, B, N, 2)).astype(np.float32),
        "nominal_action": rng.uniform(0, 1, (T, B, N, 2)).astype(np.float32),
        "higher_priority": rng.uniform(size=(T, B, N, N)) < 0.3,
    }


def _frame(module, rec):
    plt = render.pyplot()
    fig, ax = plt.subplots(figsize=(3, 2.5), dpi=60)
    module.render_frame(
        ax, "cpm_mixed", rec["pos"][1, 0], rec["rot"][1, 0],
        applied_action=rec["applied_action"][1, 0], nominal_action=rec["nominal_action"][1, 0],
        higher_priority=rec["higher_priority"][1, 0],
    )
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return buf


def test_render_frame_pixels_match_jax():
    rec = _record()
    ours, ref = _frame(render, rec), _frame(jrender, rec)
    assert ours.shape == ref.shape == (150, 180, 4)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[..., :3] < 250).any()  # something was drawn


def test_rollout_video_and_footprints(tmp_path):
    import cv2

    rec = _record(1)
    out = render.save_rollout_video("cpm_mixed", rec, str(tmp_path / "v.mp4"), env_index=1)
    cap = cv2.VideoCapture(out)
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    assert len(frames) == T and frames[0].shape[1:] == (660, 3)  # 6 in x 110 dpi
    fig = render.render_footprints("cpm_mixed", rec, str(tmp_path / "f.png"), stride=1)
    assert os.path.getsize(fig) > 1000


def test_missing_renderer_raises(monkeypatch):
    """A missing OpenCV or matplotlib raises an ImportError that names it
    (a video is never skipped silently)."""
    real = render.importlib.import_module

    def no_cv2(name, *a):
        if name == "cv2":
            raise ModuleNotFoundError("No module named 'cv2'")
        return real(name, *a)

    monkeypatch.setattr(render.importlib, "import_module", no_cv2)
    with pytest.raises(ImportError, match="'cv2'"):
        render.require_video()


def test_colors_match_jax():
    assert colors.colors == jcolors.colors
    assert colors.Color.blue100 == jcolors.Color.blue100
    assert colors.Color.red25 == jcolors.Color.red25
    assert len(colors.get_n_colors_cmap(5)) == 5


def test_interx_matches_numpy_oracle():
    """Random polyline pairs, batched through the port's interx, against
    the unbatched numpy oracle."""
    rng = np.random.default_rng(7)
    L1 = rng.normal(0, 1, (200, 6, 2)).cumsum(1) * 0.3
    L2 = rng.normal(0, 1, (200, 8, 2)).cumsum(1) * 0.3
    got = interx(torch.from_numpy(L1), torch.from_numpy(L2)).numpy()
    want = np.array([interx_bool(a, b) for a, b in zip(L1, L2)])
    np.testing.assert_array_equal(got, want)
    assert 20 < want.sum() < 180
    hit = int(np.flatnonzero(want)[0])
    assert interx_points(L1[hit], L2[hit]).shape[0] >= 1
