"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
the program (`sigmarl_tpu_torch/`). The cell's configuration, traffic and
limits are files found by name (`configs/`, `traffic/`, `workloads/`); the
traffic's `driver` runs it. Set-up (imports, the CUDA context, the
kernels' build or load, map tables, weights, warm-up) is timed from the
process's start; then the window runs for `--seconds`. With `--trace 0`
the line holds the cell's end-to-end metrics; with `--trace 1` its
per-layer metrics, each read by `metrics/<name>.py` from spans and one
profiled stretch. After the window the peak memory is read, the
program's state is freed, and the steps the seed sampled are checked
against the plain reference (`correct`); each compared number is printed
beside its limit, last on standard error and last in the line.

Exits 2 on a bad argument, 3 where the program is missing or a forbidden
module is loaded, 4 without enough cards; none of these prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.harness import guard  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


class BadArgument(ValueError):
    pass


def load(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(spec: dict, name: str):
    """(cell, configuration, traffic, limits) of the cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BadArgument(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[name]
    return (cell, load(HERE, "configs", cell["config"] + ".json"),
            load(HERE, "traffic", cell["traffic"] + ".json"),
            load(HERE, "workloads", name + ".json")["limits"])


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The per-layer metric's reader, `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def main(argv=None, device=None, overrides=None, control: bool = False) -> int:
    """One run. `device`, `overrides` ({"config": {...}, "traffic": {...}}
    merged into the files) and `control` (the reference's lower-precision
    control judged in the program's place) are for the harness's own tests
    and the control's readings; a measured run takes none of them."""
    args = parse_args(argv)
    try:
        spec = load(ROOT, "BENCHMARK.json")
        cell, config, traffic, limits = cell_files(spec, args.workload)
    except (OSError, BadArgument) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    overrides = overrides or {}
    config = merge(config, overrides.get("config", {}))
    traffic = merge(traffic, overrides.get("traffic", {}))
    try:
        guard.import_program(ROOT)
        guard.check_imports()
    except (guard.GuardError, ImportError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3

    import torch

    from benchmark.harness import card
    if device is None:
        try:
            dev = card.require_cards(cell["chips"])
        except card.NoCard as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return 4
    else:
        dev = torch.device(device)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = driver.Driver(config, traffic, limits, args.seed, dev)
    run.setup()
    setup_s = time.perf_counter() - T_START

    metrics, extra = {}, {}
    if args.trace:
        layer = run.layers(args.seconds)
        for m in spec["per_layer"]:
            if applies(m, cell["name"]):
                value = reader(m["name"])(layer)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.window(args.seconds), setup_s=setup_s)
        for m in spec["end_to_end"]:
            if applies(m, cell["name"]):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev_rec = card.device_record(dev, cell["chips"])
    if args.trace:
        tr = layer["trace"]
        dev_rec.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        extra["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    try:
        guard.check_imports()
    except guard.GuardError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3

    run.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = run.check(control=control)
    correct = bool(checks) and all(c.passes for c in checks)
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}): "
              f"{'ok' if c.passes else 'FAIL'}", file=sys.stderr)
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev_rec, **extra,
            "checks": {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                                "limit": c.limit} for c in checks}}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
