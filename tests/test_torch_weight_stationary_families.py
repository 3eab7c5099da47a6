"""Port vs reference: weight-stationary decode and context parallelism,
the MoE and SSM families (``test_torch_weight_stationary.py`` the others,
and the helpers both use).

One ``gloo`` world of 4 CPU ranks for the module (``tests/torch_worlds.py
weight_stationary``), as 2x2 and 4x1 meshes: dbrx-132b with the ELL
dispatch and the paper's ``"auto"`` rule (the router's logits summed over
``data``, so every rank routes alike; ``"auto"``'s counts not summed over
the replicated batch) and zamba2-1.2b (Mamba-2's states on the rank's
batch rows, its shared attention block), a prefill then a
weight-stationary decode step at B = 4 and B = 1 (and the same step with
its parameters gathered), held against one device and the reference.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_weight_stationary import (FAMILY_CASES, assert_decode,
                                          assert_no_parameter_gathered,
                                          cases_of, key_id, world_of)

KEYS = [(name, B) for name in FAMILY_CASES for B in (4, 1)]


@pytest.fixture(scope="module")
def inputs():
    return cases_of(FAMILY_CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    return world_of(tmp_path_factory, inputs)


@pytest.mark.parametrize("key", KEYS, ids=key_id)
def test_weight_stationary_decode_matches_one_device_and_the_reference(
        world, inputs, key):
    assert_decode(world, inputs, key)


@pytest.mark.parametrize("key", KEYS, ids=key_id)
def test_gathered_decode_matches_one_device_and_the_reference(
        world, inputs, key):
    assert_decode(world, inputs, key, gathered=True)


@pytest.mark.parametrize("key", KEYS, ids=key_id)
def test_the_decode_step_gathers_no_parameter_over_data(world, inputs, key):
    assert_no_parameter_gathered(world, inputs, key)
