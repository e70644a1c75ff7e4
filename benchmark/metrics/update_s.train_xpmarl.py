"""The XP-MARL trainer's own `seconds_update` per iteration (the captured
update's replays over the four networks), averaged over the window's
iterations."""


def read(layer):
    t = layer.get("train")
    return None if not t or not t["iterations"] else t["update_s"] / t["iterations"]
