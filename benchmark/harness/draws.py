"""Every random number a cell consumes, drawn by the benchmark from the
run's seed on the card in a few large calls and handed alike to the
program and to the reference."""

from __future__ import annotations

import dataclasses

import torch


def reset_draws(draws_cls, cfg, gen: torch.Generator, dev: torch.device, slots: int,
                steps: int | None = None):
    """The reset draws of one env step (or, with `steps`, a list of one per
    step), as `draws_cls` (the port's `ResetDraws`): the full-width spawn's
    uniforms, the compacted spawn's [slots, N, T] where `slots` > 0 (the
    env takes whichever branch its resetting envs need), the spawn speeds
    and, on cpm_mixed, the scenario draw's Gumbel noise. One uniform draw
    covers them all."""
    B, N, T = cfg.batch_dim, cfg.n_agents, cfg.max_spawn_tries
    gumbel = 3 * B if cfg.scenario_type == "cpm_mixed" else 0
    sizes = [2 * B * N * T, 2 * slots * N * T, B * N, gumbel]
    n = 1 if steps is None else steps
    flat = torch.rand((n, sum(sizes)), generator=gen, device=dev)
    out = []
    for row in flat:
        full, compact, speed, g = torch.split(row, sizes)
        full = full.view(2, B, N, T)
        kw = dict(scenario_gumbel=None, path_u=full[0], point_u=full[1],
                  speed_u=speed.view(B, N))
        if slots:
            compact = compact.view(2, slots, N, T)
            kw.update(path_u_c=compact[0], point_u_c=compact[1])
        if gumbel:
            kw["scenario_gumbel"] = -torch.log(-torch.log(g.view(B, 3).clamp(min=1e-20)))
        out.append(draws_cls(**kw))
    return out[0] if steps is None else out


def convert(obj, cls):
    """A dataclass instance `obj` as the dataclass `cls` of the same field
    names (a program's state or draws handed to the reference)."""
    if obj is None:
        return None
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def clone(obj):
    """A copy of a dataclass of tensors (None fields stay None)."""
    return type(obj)(**{f.name: (None if getattr(obj, f.name) is None
                                 else getattr(obj, f.name).clone())
                        for f in dataclasses.fields(obj)})
