"""Networks, PPO losses, optimizer, checkpoints and the MAPPO trainer."""

from sigmarl_tpu_torch.rl.mappo_cavs import (  # noqa: F401
    DecisionMakingModule,
    IterationDraws,
    MAPPOCAVs,
    OptimizationModule,
    TrainState,
    Transition,
    compute_td_error,
    mappo_cavs,
)
from sigmarl_tpu_torch.rl.networks import (  # noqa: F401
    CentralizedCritic,
    DecentralizedCritic,
    PolicyNet,
    critic_from_jax_params,
    policy_from_jax_params,
    to_jax_params,
)
