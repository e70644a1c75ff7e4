"""The XP-MARL trainer's own `seconds_rollout` per iteration (16 steps,
each the priority rank and 15 turns, then the env step), averaged over the
window's iterations."""


def read(layer):
    t = layer.get("train")
    return None if not t or not t["iterations"] else t["rollout_s"] / t["iterations"]
