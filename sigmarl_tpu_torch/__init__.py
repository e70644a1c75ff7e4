"""sigmarl_tpu_torch — the PyTorch/CUDA port of `sigmarl_tpu`.

A second package beside the JAX one: the CBF-QP-filtered rollout step of
the road-traffic simulator (policy, centralized safety filter, environment
step) on tensors, with the two hot kernels written in CUDA for Hopper
(`ops/qp.py`, `ops/boundary.py`, sources under `csrc/`). Entry points run
on `cuda` unless the caller passes `device="cpu"`, where every kernel runs
its plain PyTorch version. The package imports nothing of JAX.
"""

__version__ = "0.1.0"

from sigmarl_tpu_torch.config import Parameters  # noqa: F401
from sigmarl_tpu_torch.constants import AGENTS, SCENARIOS, THRESHOLD  # noqa: F401
from sigmarl_tpu_torch.env.env import RoadTrafficEnv, make_env  # noqa: F401
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState, zero_state  # noqa: F401
from sigmarl_tpu_torch.rl.networks import (  # noqa: F401
    PolicyNet,
    policy_from_jax_params,
    tanh_normal_sample,
)
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter, CBFStepInfo  # noqa: F401
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step  # noqa: F401
