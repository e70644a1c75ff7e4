"""A filtered iteration's counted work over the card's float32 peak times
the window's iteration time. The work: the rollout's policy forward on
B T N rows, the GAE's critic forward on both observations (B T rows
each), forward and backward of policy and critic over every minibatch
update, and each of the T steps' K1 and K2 (`work/k1_newton.py`,
`work/k2_stencil.py` at the trainer's budget)."""

from benchmark.metrics.common import k1_newton, k2_stencil, mfu_pct, mlp, on_device


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
                               + mlp.train_flops(cri, s["minibatch"]))
             + s["steps"] * (k1_newton.count(s)[0] + k2_stencil.count(s)[0]))
    return mfu_pct(flops * t["iterations"], t["seconds"])
