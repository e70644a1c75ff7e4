"""The harness end to end on the CPU at tiny sizes, the result line's
contract, BENCHMARK.json's contract, and what a run refuses."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.run import HERE, ROOT
from benchmark.tests.conftest import CELLS, SEED, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(capsys, cell, trace):
    rc, line, err = run_cell(capsys, cell, trace)
    assert rc == 0, err
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
        assert f"check {name} = " in err
    s = spec()
    if trace:
        expect = {m["name"] for m in s["per_layer"] if cell in m["workloads"]}
        # A CPU run has no device time: rooflines, shares and idle read
        # nothing; spans and counters read.
        assert set(line["metrics"]) <= expect
        assert "breakdown" in line and {"busy_s", "window_s"} <= set(line["device"])
    else:
        expect = {m["name"] for m in s["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == expect
        assert all(v["value"] > 0 for v in line["metrics"].values())
    units = {m["name"]: m["unit"] for m in s["end_to_end"] + s["per_layer"]}
    assert all(v["unit"] == units[k] for k, v in line["metrics"].items())


def test_benchmark_json_keeps_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    cells = {w["name"]: w for w in s["workloads"]}
    configs = {c["name"]: c for c in s["configs"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert set(cells) == set(CELLS) and "setup_s" in e2e
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"] and c["file"].startswith("benchmark/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        for sub, name in (("traffic", w["traffic"]), ("workloads", w["name"])):
            assert os.path.isfile(os.path.join(HERE, sub, name + ".json"))
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and NAME.match(m["name"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(HERE, "metrics", m["name"] + ".py"))
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = [m for m in s["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in s["per_layer"])


def test_a_run_without_a_card_prints_no_result(capsys):
    from benchmark import run

    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 4 and out == "" and "cuda" in err.lower()


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "sigmarl_tpu_torch" in out.stderr


def test_an_unknown_cell_is_a_bad_argument(capsys):
    from benchmark import run

    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
{imports}
from benchmark.harness.guard import forbidden_loaded, loaded_top_level
print(forbidden_loaded(), "sigmarl_tpu_torch" in loaded_top_level())
"""


@pytest.mark.parametrize("imports, program", [
    ("import benchmark.run, benchmark.readings\n"
     "from benchmark.harness import mainpath, training\n"
     "mainpath.program_modules(); import sigmarl_tpu_torch.rl.mappo_cavs\n"
     "import benchmark.drivers.rollout, benchmark.drivers.train, benchmark.drivers.latency", True),
    ("from benchmark.harness import mainpath\nmainpath.reference_modules()\n"
     "import benchmark.reference.rl.optim, benchmark.reference.rl.ppo", False),
])
def test_nothing_loads_jax_and_the_reference_loads_nothing_of_the_program(imports, program):
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=ROOT, imports=imports)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", str(program)]


def test_the_guard_compares_whole_top_level_names():
    from benchmark.harness.guard import forbidden_loaded

    assert forbidden_loaded(["sigmarl_tpu_torch.env", "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_loaded(["sigmarl_tpu.env.env", "jax._src", "optax"]) == [
        "jax", "optax", "sigmarl_tpu"]
