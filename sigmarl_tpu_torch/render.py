"""Host-side rendering: map + agents to matplotlib frames / video.

Rendering runs on the host, out of the hot path, over recorded rollouts
(the `.npz` records that `main_testing`, `main_eval` and the evaluation
layer write): the step on the device never renders. Frames are drawn with
matplotlib's Agg backend and videos encoded with OpenCV. Both are imported
inside the functions that need them, so importing this module needs
neither; a function that needs a missing one raises `ImportError`.
"""

from __future__ import annotations

import functools
import importlib
from typing import Dict, Optional

import numpy as np

from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.maps.manager import load_map


def _require(name: str):
    """Import a rendering dependency, or raise an ImportError that names it."""
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"rendering needs {name!r}, which is not installed here ({e}); "
            "render from the saved .npz records on a machine that has it"
        ) from e


def pyplot():
    """matplotlib's pyplot on the Agg backend."""
    _require("matplotlib").use("Agg")
    return _require("matplotlib.pyplot")


def require_video() -> None:
    """Raise ImportError now, before any rollout, where a video cannot be
    written (matplotlib or OpenCV missing)."""
    _require("matplotlib")
    _require("cv2")


def _rect(center, yaw, length=AGENTS["length"], width=AGENTS["width"]):
    lh, wh = length / 2, width / 2
    local = np.array([[lh, wh], [lh, -wh], [-lh, -wh], [-lh, wh]])
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    return local @ R.T + center


@functools.lru_cache(maxsize=None)
def _map(scenario_type: str):
    """The parsed map, once per process (a video draws it every frame)."""
    return load_map(scenario_type)


def draw_map(ax, scenario_type: str, show_boundaries: bool = True):
    m = _map(scenario_type)
    for lane in m.lanelets:
        for bnd, marking in (
            (lane.left_boundary, lane.left_line_marking),
            (lane.right_boundary, lane.right_line_marking),
        ):
            ax.plot(
                bnd[:, 0], bnd[:, 1],
                linestyle="--" if marking == "dashed" else "-",
                color="grey", linewidth=0.5,
            )
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    return m


def draw_action_arrows(ax, pos, rot, applied, nominal, cmap, scale=0.5):
    """CBF-vs-nominal action arrows (reference `_render_cbf_action`,
    `road_traffic.py:2007-2226`): the applied (safe) action in the agent's
    color, the nominal action in semi-transparent black. Arrow direction is
    heading + steering target; length scales with the speed target."""
    N = pos.shape[0]
    for i in range(N):
        for act, color, alpha, z in (
            (nominal[i], "black", 0.35, 4),
            (applied[i], cmap[i], 0.9, 5),
        ):
            v, steer = float(act[0]), float(act[1])
            dx = np.cos(rot[i] + steer) * v * scale
            dy = np.sin(rot[i] + steer) * v * scale
            ax.annotate(
                "", xy=(pos[i, 0] + dx, pos[i, 1] + dy),
                xytext=(pos[i, 0], pos[i, 1]),
                arrowprops=dict(arrowstyle="->", color=color, alpha=alpha,
                                lw=1.2), zorder=z,
            )


def draw_priority_lines(ax, pos, higher_priority, cmap):
    """Action-propagation lines from each higher-priority agent to the
    receiving agent, colored by the sender (reference
    `_render_action_propagation_direction`, `road_traffic.py:1942-1992`).

    higher_priority: [N, N] bool — [i, j] True when agent j's action
    propagates into agent i's observation."""
    N = pos.shape[0]
    for i in range(N):
        for j in range(N):
            if higher_priority[i, j]:
                ax.plot(
                    [pos[j, 0], pos[i, 0]], [pos[j, 1], pos[i, 1]],
                    color=cmap[j], linewidth=1.4, alpha=0.7, zorder=2,
                )


def render_frame(
    ax,
    scenario_type: str,
    pos: np.ndarray,  # [N, 2]
    rot: np.ndarray,  # [N]
    short_term: Optional[np.ndarray] = None,  # [N, S, 2]
    colors=None,
    applied_action: Optional[np.ndarray] = None,  # [N, 2]
    nominal_action: Optional[np.ndarray] = None,  # [N, 2]
    higher_priority: Optional[np.ndarray] = None,  # [N, N] bool
):
    plt = _require("matplotlib.pyplot")
    draw_map(ax, scenario_type)
    N = pos.shape[0]
    cmap = colors or [plt.cm.tab20(i % 20) for i in range(N)]
    for i in range(N):
        poly = plt.Polygon(
            _rect(pos[i], rot[i]), closed=True, facecolor=cmap[i],
            edgecolor="black", linewidth=0.4, zorder=3,
        )
        ax.add_patch(poly)
        if short_term is not None:
            ax.plot(
                short_term[i, :, 0], short_term[i, :, 1],
                color=cmap[i], linewidth=0.6, linestyle=":", zorder=2,
            )
    if applied_action is not None and nominal_action is not None:
        draw_action_arrows(ax, pos, rot, applied_action, nominal_action, cmap)
    if higher_priority is not None:
        draw_priority_lines(ax, pos, higher_priority, cmap)


def save_rollout_video(
    scenario_type: str,
    record: Dict[str, np.ndarray],
    out_file: str,
    env_index: int = 0,
    fps: int = 10,
    stride: int = 1,
    max_frames: int = 600,
):
    """Render one env of a recorded rollout to an mp4 (OpenCV encoder)."""
    plt = pyplot()
    cv2 = _require("cv2")

    pos = np.asarray(record["pos"])[:, env_index]  # [T, N, 2]
    rot = np.asarray(record["rot"])[:, env_index]
    T = min(pos.shape[0], max_frames * stride)

    fig, ax = plt.subplots(figsize=(6, 5.3), dpi=110)
    writer = None
    applied = record.get("applied_action")
    nominal = record.get("nominal_action")
    prio = record.get("higher_priority")
    for t in range(0, T, stride):
        ax.clear()
        render_frame(
            ax, scenario_type, pos[t], rot[t],
            applied_action=None if applied is None else np.asarray(applied)[t, env_index],
            nominal_action=None if nominal is None else np.asarray(nominal)[t, env_index],
            higher_priority=None if prio is None else np.asarray(prio)[t, env_index],
        )
        ax.set_title(f"t = {t}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frame = cv2.cvtColor(buf, cv2.COLOR_RGB2BGR)
        if writer is None:
            h, w = frame.shape[:2]
            writer = cv2.VideoWriter(
                out_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
            )
        writer.write(frame)
    if writer is not None:
        writer.release()
    plt.close(fig)
    return out_file


def render_footprints(
    scenario_type: str,
    record: Dict[str, np.ndarray],
    out_file: str,
    env_index: int = 0,
    stride: int = 5,
    max_steps: int = 400,
):
    """Footprint figure: vehicle rectangles over time with age-faded alpha
    (reference `evaluation_itsc26_footprints.py` — its animation distilled
    to the paper's footprint still)."""
    plt = pyplot()

    pos = np.asarray(record["pos"])[:max_steps, env_index]  # [T, N, 2]
    rot = np.asarray(record["rot"])[:max_steps, env_index]
    T, N = pos.shape[:2]
    fig, ax = plt.subplots(figsize=(6, 5.3), dpi=130)
    draw_map(ax, scenario_type)
    cmap = [plt.cm.tab20(i % 20) for i in range(N)]
    ts = list(range(0, T, stride))
    for k, t in enumerate(ts):
        alpha = 0.08 + 0.72 * (k + 1) / len(ts)
        for i in range(N):
            poly = plt.Polygon(
                _rect(pos[t, i], rot[t, i]), closed=True,
                facecolor=cmap[i], alpha=alpha, edgecolor="none", zorder=3,
            )
            ax.add_patch(poly)
    fig.savefig(out_file, bbox_inches="tight")
    plt.close(fig)
    return out_file
