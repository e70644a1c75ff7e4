"""Networks, PPO losses, optimizers, checkpoints, the MAPPO trainer, XP-MARL
(priority assignment and action propagation), opponent modeling and the
learned-CBF module."""

from sigmarl_tpu_torch.rl.cbf_module import (  # noqa: F401
    CBFModule,
    CBFModuleState,
    make_cbf_observation,
)
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
    score_critic,
    score_policy,
    to_jax_params,
)
from sigmarl_tpu_torch.rl.opponent import opponent_modeling_policy  # noqa: F401
from sigmarl_tpu_torch.rl.priority import (  # noqa: F401
    nearing_agent_indices,
    prioritized_action_propagation,
    priority_rank,
)
