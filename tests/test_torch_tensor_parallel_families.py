"""Port vs reference: train steps tensor-parallel over the ``model`` axis,
the MoE, SSM and xLSTM families (``test_torch_tensor_parallel.py`` the
dense ones, and the helpers both use).

One ``gloo`` world of 4 CPU ranks for the module
(``tests/torch_worlds.py tensor_parallel``), as 1x4, 2x2 and 4x1 meshes:
dbrx-132b (experts split), mixtral-8x22b, zamba2-1.2b (Mamba-2 heads, its
packed projection gathered) and xlstm-1.3b (mLSTM heads, sLSTM units),
each one float32 and one mixed-precision step held against the port's
one-device step and the reference's ``make_train_step``; dbrx's MoE
auxiliary loss over batch shards whose routing differs (2x2, 4x1, 1x4); a
microbatch of fewer rows than batch shards (16 rows in 8 microbatches on
4x1 and 2x2); the experts' ``ffn`` split where their count does not divide
the axis; xLSTM's recurrence run whole where its heads do not divide it;
the dropless CSR dispatch.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tensor_parallel import ARCHS, assert_step, cases, world_of

HERE = ARCHS[6:]
HERE_SPECIAL = ("dbrx_routing", "padded", "ffn_split", "xlstm_2_heads",
                "moe_csr")


@pytest.fixture(scope="module")
def inputs():
    return cases(HERE, HERE_SPECIAL)


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    return world_of(tmp_path_factory, inputs)


@pytest.mark.parametrize("arch", HERE)
def test_tensor_parallel_train_step_matches_one_device_and_the_reference(
        world, inputs, arch, record_property):
    """Loss, grad norm, every leaf's clipped gradient and every parameter
    (the float32 masters when mixed) after one step on 1x4 and 2x2,
    float32 and mixed precision; each rank computed with its ``model``
    shards, and its replicated leaves are its group's bit for bit."""
    assert_step(world, inputs, arch, record_property)


def test_moe_aux_loss_is_the_global_microbatchs(world, inputs,
                                                record_property):
    """dbrx with each quarter of the rows routed from its own quarter of
    the vocabulary: on 2x2, 4x1 and 1x4 the loss, grad norm and
    parameters are one device's and the reference's (the auxiliary loss's
    batch means taken over the whole microbatch, not a mean of the
    shards')."""
    assert_step(world, inputs, "dbrx_routing", record_property)


def test_a_microbatch_of_fewer_rows_than_shards_is_padded(
        world, inputs, record_property):
    """16 rows in 8 microbatches on 4x1 (and 2x2): each microbatch's 2 rows
    padded to 4 with rows of labels ``-1``, left out of the loss and the
    router's statistics: one device's step and the reference's."""
    assert_step(world, inputs, "padded", record_property)


@pytest.mark.parametrize("key", ["ffn_split", "xlstm_2_heads", "moe_csr"])
def test_tensor_parallel_layouts_match_one_device(world, inputs, key,
                                                  record_property):
    """2 experts on a model axis of 4 (each expert's ffn split), 2 xLSTM
    heads on 4 (the recurrence whole on each rank, sLSTM on each head's
    units), dbrx's dropless CSR dispatch (each rank its experts' rows):
    one device's step."""
    assert_step(world, inputs, key, record_property)
