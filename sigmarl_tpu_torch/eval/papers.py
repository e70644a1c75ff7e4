"""Paper-experiment drivers of the port.

Each function configures the sweep one paper reports and runs it through
the shared training, evaluation and rollout machinery (the original
SigmaRL's `evaluation_itsc24.py`, `_icra25`, `_ecc25`, `_lcss25`,
`_itsc25` and `_itsc26`). Run as

    python -m sigmarl_tpu_torch.eval.papers <name> [--quick]
        [--device {cuda,cpu}] [--no_figures] [--out_dir DIR]

A driver computes on the device (`cuda` unless `--device cpu` is given)
and writes its `results.json` and its `.npz` records first; it draws its
figures after that. `--no_figures` leaves them out (the card's machine
has no matplotlib); with figures asked for, a missing matplotlib or
OpenCV raises an ImportError before the run starts.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from sigmarl_tpu_torch import render
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.eval import metrics as M
from sigmarl_tpu_torch.eval.rollout import constant_speed_policy, rollout
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
from sigmarl_tpu_torch.rl.networks import tanh_normal_mode
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter


def _write_json(out_dir: str, name: str, obj) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(obj, f, indent=1)


def _save_record(out_dir: str, name: str, record: Dict[str, np.ndarray]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, name), **record)


def _reward_history(trainer: MAPPOCAVs) -> List[float]:
    hist = []
    trainer.train(progress_callback=lambda i, m: hist.append(float(m["episode_reward_mean"])))
    return hist


def itsc24_observation_ablation(
    scenarios: List[str] = ("cpm_mixed", "intersection_1"),
    n_sims: int = 32,
    max_steps: int = 1200,
    quick: bool = False,
    out_dir: str = "outputs/itsc24",
    device=None,
) -> Dict:
    """Observation-design ablation M0-M5: train with each observation
    switch off in turn, then test the trained policy (deterministic) in
    testing mode. Training length is a compute knob; the protocol is the
    point."""
    designs = {
        "M0_full": {},
        "M1_bird_view": {"is_ego_view": False},
        "M2_no_vertices": {"is_observe_vertices": False},
        "M3_no_distances_agents": {"is_observe_distance_to_agents": False},
        "M4_boundary_points": {"is_observe_distance_to_boundaries": False},
        "M5_no_center_line_distance": {"is_observe_distance_to_center_line": False},
    }
    n_iters, n_train_envs, epochs, mb = 15, 32, 10, 256
    if quick:
        n_sims, max_steps = 4, 48
        n_iters, n_train_envs, epochs, mb = 1, 8, 2, 64
    device = device or "cuda"

    results = {}
    for scenario in scenarios:
        for name, kw in designs.items():
            p_train = Parameters(
                scenario_type=scenario, n_agents=4, num_vmas_envs=n_train_envs,
                dt=0.1, max_steps=32 if quick else 128, n_iters=n_iters,
                num_epochs=epochs, minibatch_size=mb,
                is_use_mtv_distance=False, is_obs_noise=False,
                where_to_save=out_dir + "/train/",
                model_name=f"{scenario}_{name}", device=device, **kw,
            )
            _, dm, *_ = MAPPOCAVs(p_train).train()
            p = Parameters(
                scenario_type=scenario, n_agents=4, num_vmas_envs=n_sims, dt=0.1,
                max_steps=max_steps, is_use_mtv_distance=False, is_obs_noise=False,
                is_testing_mode=True, device=device, **kw,
            )
            env = make_env(p)

            @torch.no_grad()
            def policy_fn(obs, generator, noise, dm=dm):
                loc, _ = dm.net(obs)
                return tanh_normal_mode(loc, dm.low, dm.high)

            gen = torch.Generator(device=env.device).manual_seed(0)
            record, _ = rollout(env, policy_fn, max_steps, gen)
            _save_record(out_dir, f"out_td_{scenario}_{name}.npz", record)
            res = M.basic_metrics(record)
            res["obs_dim"] = env.obs_dim
            results[f"{scenario}/{name}"] = res
    _write_json(out_dir, "results.json", results)
    return results


def icra25_priority_strategies(quick: bool = False, out_dir: str = "outputs/icra25",
                               device=None) -> Dict:
    """XP-MARL priority strategies: random against learned prioritization,
    short training runs; the episode-reward history of each."""
    results = {}
    for method in ("random", "marl"):
        p = Parameters(
            scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=8 if quick else 32,
            dt=0.1, max_steps=32 if quick else 128, n_iters=2 if quick else 50,
            num_epochs=2 if quick else 30, minibatch_size=64 if quick else 512,
            is_use_mtv_distance=False, is_using_prioritized_marl=True,
            prioritization_method=method, where_to_save=out_dir + "/", device=device or "cuda",
        )
        results[method] = {"episode_reward_history": _reward_history(MAPPOCAVs(p))}
    _write_json(out_dir, "results.json", results)
    return results


def ecc25_cbf_grid(out_dir: str = "outputs/ecc25", device=None, figures: bool = True) -> Dict:
    """Scenario x safety-margin grid of the two-agent CBF demo, with the
    RL nominal controller's runs, and per run a figure (footprints, h(t),
    nominal against filtered inputs) and one mp4 per scenario (c2c). The
    "mtv" column's predictor is trained here on exact MTV data (60 epochs;
    the original loads a released checkpoint). Each run's seconds are
    timed to its trajectory on the host."""
    from sigmarl_tpu_torch.safety.cbf_demo import (
        CBFDemoConfig, animate_demo, fit_rl_nominal, plot_demo, run_demo,
    )
    from sigmarl_tpu_torch.safety.sm_predictor import SafetyMarginEstimatorModule

    if figures:
        render.require_video()
    sm_module = SafetyMarginEstimatorModule(device=device)
    t0 = time.perf_counter()
    sm_module.train(epochs=60, verbose=False)
    results = {"sm_predictor": {"error_upper_bound": sm_module.error_upper_bound,
                                "final_val_loss": sm_module.val_losses_history[-1],
                                "seconds": time.perf_counter() - t0}}
    runs = [(CBFDemoConfig(scenario=scen, sm_type=sm), f"{scen}/{sm}", f"demo_{scen}_{sm}")
            for scen in ("overtaking", "bypassing") for sm in ("c2c", "mtv", "grid")]
    t0 = time.perf_counter()
    policy, bc_loss = fit_rl_nominal(CBFDemoConfig(nominal="rl"), device=device)
    results["rl_nominal_fit"] = {"bc_fit_loss": bc_loss, "seconds": time.perf_counter() - t0}
    runs += [(CBFDemoConfig(scenario=scen, sm_type="c2c", nominal="rl"),
              f"{scen}/c2c/rl_nominal", f"demo_{scen}_c2c_rlnom")
             for scen in ("overtaking", "bypassing")]
    trajs = {}
    for cfg, key, stem in runs:
        t0 = time.perf_counter()
        t = run_demo(cfg, sm_module=sm_module,
                     rl_policy_params=policy if cfg.nominal == "rl" else None, device=device)
        results[key] = {"h_min": t["h_min"], "collided": t["collided"],
                        "seconds": time.perf_counter() - t0}
        if cfg.nominal == "rl":
            results[key]["bc_fit_loss"] = bc_loss
        _save_record(out_dir, stem + ".npz", {k: v for k, v in t.items() if isinstance(v, np.ndarray)})
        trajs[key] = (cfg, stem, t)
    _write_json(out_dir, "results.json", results)
    if figures:
        for key, (cfg, stem, t) in trajs.items():
            results[key]["figure"] = plot_demo(t, cfg, os.path.join(out_dir, stem + ".png"))
            if cfg.sm_type == "c2c" and cfg.nominal == "scripted":
                results[key]["animation"] = animate_demo(t, cfg, os.path.join(out_dir, stem + ".mp4"))
        _write_json(out_dir, "results.json", results)
    return results


def lcss25_ttcbf(quick: bool = False, out_dir: str = "outputs/lcss25", device=None,
                 figures: bool = True) -> Dict:
    """TTCBF against HOCBF: the (lambda_1, dt) sweep of each relative degree
    and approach (15 x 15, 400 steps; quick 5 x 5, 150 steps), its
    collision fraction and seconds, and a heatmap each."""
    from sigmarl_tpu_torch.safety import hocbf_taylor as H

    if figures:
        render.pyplot()
    n = 5 if quick else 15
    results, grids = {}, {}
    for deg in (1, 2):
        for appr in ("taylor", "hocbf"):
            cfg = H.HOCBFConfig(relative_degree=deg, approach=appr,
                                num_steps=150 if quick else 400,
                                lambda_1=0.5 if appr == "taylor" else 3.0, lambda_2=3.0)
            t0 = time.perf_counter()
            res = H.run_experiment_multi_parameters(
                cfg, np.linspace(0.1, 1.0 if appr == "taylor" else 5.0, n),
                np.linspace(0.005, 0.05, n), device=device)
            stem = f"heatmap_deg{deg}_{appr}"
            results[f"deg{deg}/{appr}"] = {"collision_fraction": float(res["collided"].mean()),
                                           "seconds": time.perf_counter() - t0}
            _save_record(out_dir, stem + ".npz", res)
            grids[stem] = res
    _write_json(out_dir, "results.json", results)
    if figures:
        for stem, res in grids.items():
            H.plot_heatmap(res, os.path.join(out_dir, stem + ".png"))
    return results


def itsc25_safety_filter(quick: bool = False, out_dir: str = "outputs/itsc25", device=None,
                         max_steps: int | None = None, circles=None) -> Dict:
    """CBF-filter sweep over the number of approximating circles (one
    agent, cpm_mixed, testing mode, the CLF nominal controller at 0.6
    m/s): collision counts, the QP infeasibility rate, the per-step timing
    and the share of steps that ran the reset. `max_steps` cuts the
    paper's 600 steps (quick: 32) and `circles` picks circle counts of the
    sweep (1 to 5; quick: 1 and 3)."""
    n_sims = 4 if quick else 32
    steps = max_steps or (32 if quick else 600)
    circle_sweep = circles or ((1, 3) if quick else (1, 2, 3, 4, 5))
    results = {}
    for n_circles in circle_sweep:
        p = Parameters(
            scenario_type="cpm_mixed", n_agents=1, num_vmas_envs=n_sims, dt=0.1,
            max_steps=steps, is_use_mtv_distance=False, is_obs_noise=False,
            is_testing_mode=True, n_circles_approximate_vehicle=n_circles,
            device=device or "cuda",
        )
        env = make_env(p)
        cbf = CBFSafetyFilter(
            CBFConfig(n_agents=1, n_circles=n_circles, dt=0.1, nom_controller_type="clf"),
            env.cfg, env.tables, device=env.device,
        )
        gen = torch.Generator(device=env.device).manual_seed(0)
        record, timings = rollout(env, constant_speed_policy(env, 0.6), steps, gen, cbf=cbf)
        _save_record(out_dir, f"out_td_c{n_circles}.npz", record)
        res = M.basic_metrics(record)
        res.update({f"timing_{k}": round(v, 4) for k, v in timings.items()})
        res["reset_share"] = env.reset_steps / steps
        results[f"n_circles={n_circles}"] = res
    _write_json(out_dir, "results.json", results)
    return results


def itsc26_reward_sweep(quick: bool = False, out_dir: str = "outputs/itsc26", device=None) -> Dict:
    """CBF-informed reward sweep: training curves across reward methods and
    h_nom values."""
    sweeps = ([("distance", None), ("cbf", 0.2)] if quick
              else [("distance", None), ("cbf", 0.1), ("cbf", 0.2)])
    results = {}
    for method, h_nom in sweeps:
        p = Parameters(
            scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=4 if quick else 32, dt=0.1,
            max_steps=16 if quick else 128, n_iters=1 if quick else 30,
            num_epochs=1 if quick else 30, minibatch_size=32 if quick else 512,
            is_use_mtv_distance=False, rew_method=method,
            is_using_cbf_training=method == "cbf", is_solve_qp=False,
            h_nom=h_nom or 0.2, where_to_save=out_dir + "/", device=device or "cuda",
        )
        results[f"{method}_hnom{h_nom}"] = {"episode_reward_history": _reward_history(MAPPOCAVs(p))}
    _write_json(out_dir, "results.json", results)
    return results


def robust_stats(vals: np.ndarray) -> Dict[str, float]:
    """Summary statistics over the finite values."""
    vals = np.asarray(vals, float)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return {k: float("nan") for k in
                ("count", "mean", "std", "q10", "q50", "q90", "min", "max")}
    return {
        "count": float(vals.size),
        "mean": float(vals.mean()),
        "std": float(vals.std()),
        "q10": float(np.quantile(vals, 0.10)),
        "q50": float(np.quantile(vals, 0.50)),
        "q90": float(np.quantile(vals, 0.90)),
        "min": float(vals.min()),
        "max": float(vals.max()),
    }


def sobol_from_grid(z: np.ndarray) -> Dict[str, float]:
    """First-order, interaction and total Sobol indices of a metric over a
    2-D parameter grid z[ta, tb], uniform over the finite cells (the
    textbook variance decomposition)."""
    z = np.asarray(z, float)
    finite = np.isfinite(z)
    if not finite.any():
        return {k: float("nan") for k in ("V", "S_tb", "S_ta", "S_int", "T_tb", "T_ta")}
    V = float(np.var(z[finite]))
    if V <= 1e-12:
        return {"V": V, "S_tb": 0.0, "S_ta": 0.0, "S_int": 0.0, "T_tb": 0.0, "T_ta": 0.0}
    m_tb = np.nanmean(z, axis=0)
    m_ta = np.nanmean(z, axis=1)
    V_tb = float(np.var(m_tb[np.isfinite(m_tb)])) if np.isfinite(m_tb).any() else 0.0
    V_ta = float(np.var(m_ta[np.isfinite(m_ta)])) if np.isfinite(m_ta).any() else 0.0
    V_int = max(0.0, V - V_tb - V_ta)
    return {"V": V, "S_tb": V_tb / V, "S_ta": V_ta / V, "S_int": V_int / V,
            "T_tb": 1.0 - V_ta / V, "T_ta": 1.0 - V_tb / V}


def itsc26_robustness(quick: bool = False, out_dir: str = "outputs/itsc26", device=None) -> Dict:
    """Threshold-sweep robustness report: the final mean episode reward of
    short CBF-informed training runs over a 2-D grid of (t_a agent
    proximity threshold, t_b boundary proximity threshold), with Sobol
    sensitivity indices and robust statistics of the surface."""
    ta_grid = [0.2, 0.3] if quick else [0.15, 0.225, 0.3, 0.375]
    tb_grid = [0.01, 0.02] if quick else [0.01, 0.02, 0.03, 0.04]
    z = np.full((len(ta_grid), len(tb_grid)), np.nan)
    for a, ta in enumerate(ta_grid):
        for b, tb in enumerate(tb_grid):
            p = Parameters(
                scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=4 if quick else 32, dt=0.1,
                max_steps=16 if quick else 128, n_iters=1 if quick else 8,
                num_epochs=1 if quick else 10, minibatch_size=32 if quick else 256,
                is_use_mtv_distance=False, rew_method="cbf",
                is_using_cbf_training=True, is_solve_qp=False,
                threshold_near_other_agents_c2c_high=ta, threshold_near_boundary_high=tb,
                where_to_save=out_dir + "/robustness/", model_name=f"ta{ta}_tb{tb}",
                is_save_intermediate_model=False, device=device or "cuda",
            )
            z[a, b] = _reward_history(MAPPOCAVs(p))[-1]
    report = {"ta_grid": ta_grid, "tb_grid": tb_grid, "episode_reward_grid": z.tolist(),
              "robust_stats": robust_stats(z), "sobol": sobol_from_grid(z)}
    _write_json(out_dir, "robustness_report.json", report)
    return report


def itsc26_footprints(quick: bool = False, out_dir: str = "outputs/itsc26", device=None,
                      figures: bool = True) -> Dict:
    """The footprint figure of a recorded testing-mode rollout (cpm_mixed,
    four agents at 0.5 m/s)."""
    if figures:
        render.pyplot()
    n_sims = 2
    max_steps = 24 if quick else 300
    p = Parameters(
        scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=n_sims, dt=0.1,
        max_steps=max_steps + 1, is_use_mtv_distance=False, is_obs_noise=False,
        is_testing_mode=True, device=device or "cuda",
    )
    env = make_env(p)
    gen = torch.Generator(device=env.device).manual_seed(0)
    record, _ = rollout(env, constant_speed_policy(env, 0.5), max_steps, gen)
    _save_record(out_dir, "out_td_footprints.npz", record)
    out = {"record": os.path.join(out_dir, "out_td_footprints.npz")}
    if figures:
        out["figure"] = render.render_footprints(
            p.scenario_type, record, os.path.join(out_dir, "footprints.png"))
    return out


EXPERIMENTS = {
    "itsc24": itsc24_observation_ablation,
    "icra25": icra25_priority_strategies,
    "ecc25": ecc25_cbf_grid,
    "lcss25": lcss25_ttcbf,
    "itsc25": itsc25_safety_filter,
    "itsc26": itsc26_reward_sweep,
    "itsc26_robustness": itsc26_robustness,
    "itsc26_footprints": itsc26_footprints,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run a paper experiment (PyTorch port)")
    ap.add_argument("name", choices=sorted(EXPERIMENTS))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no_figures", action="store_true",
                    help="write results.json and the .npz records only")
    ap.add_argument("--out_dir", default=None)
    args = ap.parse_args(argv)
    fn = EXPERIMENTS[args.name]
    accepted = inspect.signature(fn).parameters
    kwargs = {"device": args.device}
    if "quick" in accepted:
        kwargs["quick"] = args.quick
    if "figures" in accepted:
        kwargs["figures"] = not args.no_figures
    if args.out_dir:
        kwargs["out_dir"] = args.out_dir
    results = fn(**kwargs)
    print(json.dumps(results, indent=1, default=str))
    return results


if __name__ == "__main__":
    main()
