"""sigmarl_tpu_torch — the PyTorch/CUDA port of `sigmarl_tpu`.

A second package beside the JAX one: the road-traffic simulator (CPM and
OSM maps, training and testing mode), the CBF-QP safety filter
(centralized, decentralized, grouped or margins-only; RL or CLF nominal
controller), MAPPO training (`rl/`, `python -m
sigmarl_tpu_torch.main_training`; plain, CBF-filtered or CBF-informed
rollouts, XP-MARL priorities, opponent modeling, the learned-CBF module,
the challenging initial-state buffer), testing and evaluation (`eval/`,
`python -m sigmarl_tpu_torch.main_testing`, `.main_eval`,
`.main_eval_parallel`, the paper drivers `.eval.papers`), host-side
rendering (`render.py`) and the standalone ECC'25 and LCSS'25 CBF studies
(`safety/{sm_predictor,cbf_demo,hocbf_taylor}.py`) on tensors, with the
two hot kernels written in CUDA for Hopper (`ops/qp.py`, `ops/boundary.py`,
sources under `csrc/`). Entry points run
on `cuda` unless the caller passes `device="cpu"`, where every kernel runs
its plain PyTorch version. The package imports nothing of JAX.
"""

__version__ = "0.1.0"

from sigmarl_tpu_torch.config import Parameters  # noqa: F401
from sigmarl_tpu_torch.constants import AGENTS, SCENARIOS, THRESHOLD  # noqa: F401
from sigmarl_tpu_torch.env.env import RoadTrafficEnv, make_env  # noqa: F401
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState, zero_state  # noqa: F401
from sigmarl_tpu_torch.rl.cbf_module import CBFModule  # noqa: F401
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs, mappo_cavs  # noqa: F401
from sigmarl_tpu_torch.rl.networks import (  # noqa: F401
    CentralizedCritic,
    PolicyNet,
    critic_from_jax_params,
    policy_from_jax_params,
    score_critic,
    score_policy,
    tanh_normal_sample,
)
from sigmarl_tpu_torch.rl.opponent import opponent_modeling_policy  # noqa: F401
from sigmarl_tpu_torch.rl.priority import prioritized_action_propagation, priority_rank  # noqa: F401
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter, CBFStepInfo  # noqa: F401
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step, cbf_margin_step  # noqa: F401
