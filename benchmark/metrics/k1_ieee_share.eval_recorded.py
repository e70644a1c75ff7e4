"""The share of K1's env solves in the traced chunk that K1 did again with
IEEE divisions, in %: the program's count `k1.ieee_resolves` (held on the
card, collected after the chunk) over K1's launches x B. None where the
program does not count them or K1 did not launch (a CPU run)."""


def read(layer):
    k1 = layer.get("k1_ieee")
    if not k1 or k1[0] <= 0:
        return None
    launches, resolves = k1
    return resolves / (launches * layer["batch"]) * 100.0
