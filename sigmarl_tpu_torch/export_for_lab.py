"""Export a trained policy for the CPM lab: the best checkpoint's policy
parameters (`policy.pkl`, the flax-layout tree of numpy arrays that both
packages read) and the run's full parameters (`parameters.json`), so the
lab runtime can reload them standalone.

    python -m sigmarl_tpu_torch.export_for_lab <model_dir> [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.rl import checkpoint as ckpt


def export_for_lab(model_path: str, out_dir: str = "outputs/lab_export") -> str:
    """Write `policy.pkl` and `parameters.json` of the model directory's
    best checkpoint (the parameters of its last `_data.json` sidecar) to
    out_dir; returns out_dir."""
    sidecars = sorted(f for f in os.listdir(model_path) if f.endswith("_data.json"))
    if not sidecars:
        raise FileNotFoundError(f"no *_data.json sidecar in {model_path}")
    with open(os.path.join(model_path, sidecars[-1])) as f:
        data = json.load(f)
    parameters = Parameters.from_dict(data["parameters"])
    parameters.where_to_save = os.path.dirname(model_path.rstrip("/")) + "/"
    parameters.model_name = os.path.basename(model_path.rstrip("/"))
    params = ckpt.load_best(parameters)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "policy.pkl"), "wb") as f:
        pickle.dump(params["policy"], f)
    with open(os.path.join(out_dir, "parameters.json"), "w") as f:
        json.dump(data["parameters"], f, indent=1)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export a trained policy for the CPM lab")
    ap.add_argument("model_path", help="trained model directory")
    ap.add_argument("--out_dir", default="outputs/lab_export")
    args = ap.parse_args(argv)
    print(f"exported policy + parameters to {export_for_lab(args.model_path, args.out_dir)}")


if __name__ == "__main__":
    main()
