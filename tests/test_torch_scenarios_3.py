"""Every scenario of the registry in the port against the JAX package,
in training and in testing mode (`torch_parity.assert_scenario_matches_jax`):
group 3 of 5 (`scenario_group`), so that each file runs in about a
minute alone (the JAX package compiles its map tables, reset and step
anew for every scenario)."""

import pytest
import torch

from tests.torch_parity import assert_scenario_matches_jax, scenario_group

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["training", "testing"])
@pytest.mark.parametrize("scenario", scenario_group(2))
def test_scenario_reset_and_steps_match_jax(scenario, mode):
    assert_scenario_matches_jax(scenario, testing=mode == "testing")
