"""The filtered trainer's own `seconds_rollout` per iteration (16 filtered
steps), averaged over the window's iterations."""


def read(layer):
    t = layer.get("train")
    return None if not t or not t["iterations"] else t["rollout_s"] / t["iterations"]
