"""What a run may load and where the program under test comes from."""

from __future__ import annotations

import importlib
import os
import sys

# Top-level module names no run may hold: JAX, its libraries, and the JAX
# package the port was made from. Compared as whole names, since the
# port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "sigmarl_tpu")
PROGRAM = "sigmarl_tpu_torch"


class GuardError(RuntimeError):
    """The run cannot stand: a forbidden module is loaded, or the program
    is missing from the checkout."""


def loaded_top_level(modules=None) -> set:
    """The top-level names (before the first dot) of the loaded modules."""
    return {name.split(".")[0] for name in (sys.modules if modules is None else modules)}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    return sorted(loaded_top_level(modules) & set(FORBIDDEN))


def check_imports() -> None:
    """Raise GuardError naming every forbidden module that is loaded."""
    found = forbidden_loaded()
    if found:
        raise GuardError(f"forbidden modules are loaded: {', '.join(found)}")


def import_program(root: str):
    """The port's package, imported from the checkout at `root` and only
    from there: a checkout that holds only the benchmark has no program."""
    if not os.path.isdir(os.path.join(root, PROGRAM)):
        raise GuardError(f"no {PROGRAM}/ beside the benchmark in {root}")
    if root not in sys.path:
        sys.path.insert(0, root)
    pkg = importlib.import_module(PROGRAM)
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if where != os.path.join(root, PROGRAM):
        raise GuardError(f"{PROGRAM} was imported from {where}, not from the checkout {root}")
    return pkg
