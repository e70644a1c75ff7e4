"""An XP-MARL iteration's counted work over the card's float32 peak times
the window's iteration time. The work: the rollout's policy forward on
B T N rows of the padded observation (N turns of B rows a step) and the
priority actor's on B T N rows; the GAE's forward of both critics on both
observations (B T rows each); forward and backward of all four networks
over every minibatch update."""

from benchmark.metrics.common import mfu_pct, mlp, on_device


def read(layer):
    t = layer.get("train")
    if not t or not t["iterations"] or not on_device(layer):
        return None
    s = t["shapes"]
    n = s["n_agents"]
    pol = [s["obs_dim"], *s["hidden"], 4]
    cri = [n * s["obs_dim"], *s["critic_hidden"], 1]
    prio = [s["prio_obs_dim"], *s["prio_hidden"], 2]
    prio_cri = [n * s["prio_obs_dim"], *s["prio_critic_hidden"], 1]
    frames, mb = s["batch"] * s["steps"], s["minibatch"]
    flops = (mlp.forward_flops(pol, frames * n) + mlp.forward_flops(prio, frames * n)
             + 2 * mlp.forward_flops(cri, frames) + 2 * mlp.forward_flops(prio_cri, frames)
             + s["updates"] * (mlp.train_flops(pol, mb * n) + mlp.train_flops(cri, mb)
                               + mlp.train_flops(prio, mb * n) + mlp.train_flops(prio_cri, mb)))
    return mfu_pct(flops * t["iterations"], t["seconds"])
