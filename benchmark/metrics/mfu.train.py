"""An iteration's counted work (the rollout's policy forward, the GAE's
critic forward on both observations, forward and backward of policy and
critic over every minibatch update) over the card's float32 peak times
the window's iteration time."""

from benchmark.metrics.common import mfu_pct, mlp, on_device


def read(layer):
    t = layer.get("train")
    if not t or not t["iterations"] or not on_device(layer):
        return None
    s = t["shapes"]
    pol = [s["obs_dim"], *s["hidden"], 4]
    cri = [s["n_agents"] * s["obs_dim"], *s["critic_hidden"], 1]
    frames = s["batch"] * s["steps"]
    flops = (mlp.forward_flops(pol, frames * s["n_agents"]) + 2 * mlp.forward_flops(cri, frames)
             + s["updates"] * (mlp.train_flops(pol, s["minibatch"] * s["n_agents"])
                               + mlp.train_flops(cri, s["minibatch"])))
    return mfu_pct(flops * t["iterations"], t["seconds"])
