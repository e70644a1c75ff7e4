"""The benchmark of the PyTorch/CUDA port (`sigmarl_tpu_torch`).

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Each cell
names a configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`, whose `driver` picks `drivers/<driver>.py`); its
correctness limits are in `workloads/<cell>.json`; each per-layer metric is
read by `metrics/<metric>.py`; the kernels' work counts are in `work/`; the
plain reference that decides `correct` is `reference/`, a frozen copy of
the port's plain forms that imports nothing of the port.
"""
