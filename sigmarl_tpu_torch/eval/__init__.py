from sigmarl_tpu_torch.eval import metrics  # noqa: F401
from sigmarl_tpu_torch.eval.evaluation_base import Evaluation  # noqa: F401
from sigmarl_tpu_torch.eval.rollout import rollout  # noqa: F401
