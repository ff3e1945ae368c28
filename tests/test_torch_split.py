"""The port's TensorSplitter / StepOutput on the cases of
``tests/test_split.py``: nested structures, non_split_inputs,
input_split_axes, the smp_slice protocol, divisibility errors and the
StepOutput reductions. Where a case has a JAX counterpart, both packages
split the same numpy data and must give identical microbatches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smdistributed_modelparallel_tpu.backend import split as jax_split
from smdistributed_modelparallel_tpu_torch.backend.split import (
    DeferredSplit,
    NonSplit,
    StepOutput,
    TensorSplitter,
    microbatch_slice,
    stack_leaf,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import MicrobatchError


def test_basic_split():
    sp = TensorSplitter(4)
    x = torch.arange(8 * 3).reshape(8, 3)
    (stacked,), _ = sp.stack_microbatches((x,), {}, arg_names=["x"])
    assert isinstance(stacked, DeferredSplit)
    assert stacked.stack().shape == (4, 2, 3)
    torch.testing.assert_close(microbatch_slice(stacked, 1), x[2:4])


def test_nested_structures():
    sp = TensorSplitter(2)
    batch = {"ids": torch.ones((4, 5)), "inner": [torch.zeros((4,)), torch.ones((4, 2))]}
    (stacked,), _ = sp.stack_microbatches((batch,), {}, arg_names=["batch"])
    assert stacked["ids"].stack().shape == (2, 2, 5)
    assert stacked["inner"][0].stack().shape == (2, 2)
    assert stacked["inner"][1].stack().shape == (2, 2, 2)


def test_non_split_inputs():
    sp = TensorSplitter(2, non_split_inputs=["mask"])
    args, kwargs = sp.stack_microbatches(
        (torch.ones((4, 2)),), {"mask": torch.ones((3, 3))}, arg_names=["x"]
    )
    assert isinstance(kwargs["mask"], NonSplit)
    assert microbatch_slice(kwargs["mask"], 0).shape == (3, 3)


def test_input_split_axes():
    sp = TensorSplitter(2, input_split_axes={"x": 1})
    (stacked,), _ = sp.stack_microbatches((torch.arange(12).reshape(3, 4),), {}, ["x"])
    assert stacked.stack().shape == (2, 3, 2)
    np.testing.assert_array_equal(microbatch_slice(stacked, 0).numpy(), np.arange(12).reshape(3, 4)[:, :2])


def test_indivisible_raises():
    sp = TensorSplitter(3)
    with pytest.raises(MicrobatchError):
        sp.stack_microbatches((torch.ones((4, 2)),), {}, ["x"])


def test_smp_slice_protocol():
    class Custom:
        def __init__(self):
            self.data = np.arange(8)

        def smp_slice(self, num_mb, mb, axis):
            per = len(self.data) // num_mb
            return self.data[mb * per:(mb + 1) * per]

    sp = TensorSplitter(4)
    (stacked,), _ = sp.stack_microbatches((Custom(),), {}, ["c"])
    assert stacked.stack().shape == (4, 2)
    np.testing.assert_array_equal(stacked.slice(2).numpy(), [4, 5])


def test_scalars_broadcast():
    sp = TensorSplitter(2)
    args, _ = sp.stack_microbatches((3.5, "tag"), {}, ["lr", "name"])
    assert microbatch_slice(args[0], 0) == 3.5
    assert microbatch_slice(args[1], 1) == "tag"


def test_step_output_reductions():
    stacked = {"loss": torch.tensor([1.0, 3.0]), "logits": torch.ones((2, 4, 5))}
    out = StepOutput(stacked)
    assert float(out.reduce_mean()["loss"]) == 2.0
    assert float(out.reduce_sum()["loss"]) == 4.0
    assert out.concat()["logits"].shape == (8, 5)
    assert out.stack()["logits"].shape == (2, 4, 5)
    assert len(out.outputs) == 2
    assert float(out.outputs[1]["loss"]) == 3.0


@pytest.mark.parametrize("shape,axis,num_mb", [((8, 3), 0, 4), ((3, 4, 6), 1, 2), ((2, 6), 1, 3), ((6,), 0, 6)])
def test_split_matches_jax(shape, axis, num_mb):
    """Both packages cut the same array into the same microbatches, in the
    same order, stacked and one by one."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    (jax_leaf,), _ = jax_split.TensorSplitter(num_mb, input_split_axes={"x": axis}).stack_microbatches(
        (jnp.asarray(x),), {}, ["x"])
    (port_leaf,), _ = TensorSplitter(num_mb, input_split_axes={"x": axis}).stack_microbatches(
        (torch.from_numpy(x),), {}, ["x"])
    np.testing.assert_array_equal(port_leaf.stack().numpy(), np.asarray(jax_leaf.stack()))
    np.testing.assert_array_equal(stack_leaf(torch.from_numpy(x), axis, num_mb).numpy(),
                                  np.asarray(jax_split.stack_leaf(jnp.asarray(x), axis, num_mb)))
    for mb in range(num_mb):
        np.testing.assert_array_equal(microbatch_slice(port_leaf, mb).numpy(),
                                      np.asarray(jax_split.microbatch_slice(jax_leaf, mb)))


def test_step_output_matches_jax():
    rng = np.random.default_rng(1)
    stacked = {"loss": rng.standard_normal(4).astype(np.float32),
               "h": rng.standard_normal((4, 3, 5)).astype(np.float32)}
    jout = jax_split.StepOutput({k: jnp.asarray(v) for k, v in stacked.items()})
    pout = StepOutput({k: torch.from_numpy(v) for k, v in stacked.items()})
    for method in ("reduce_mean", "reduce_sum", "concat", "stack"):
        want, got = getattr(jout, method)(), getattr(pout, method)()
        for k in stacked:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=method)
