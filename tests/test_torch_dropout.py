"""The port's dropout op (``ops/dropout.py``, its plain version on the CPU)
against flax's ``nn.Dropout`` with the same key.

flax's Dropout draws ``bernoulli(make_rng("dropout"), 1 - rate, x.shape)``
and returns ``select(mask, x / (1 - rate), 0)``; as the root module of an
``apply``, its key is the applied key folded with its scope counter 1
(``fold_in_static(key, (1,))``). y and the gradient dx must equal flax's bit
for bit in fp32, bf16 and fp16 at rates 0, 0.1, 0.5 and 1 (flax returns
zeros at 1 without drawing). The wrappers' contract on other devices is
held with meta tensors through the ``_is_cuda`` seam.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu_torch.ops import dropout as port_dropout
from smdistributed_modelparallel_tpu_torch.utils import random

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dropout_matches_flax(dtype, rate):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(int(rate * 10))
    x = (rng.standard_normal((4, 33, 64)) * 3).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    k = jax.random.key(42)
    layer = fnn.Dropout(rate, deterministic=False)
    y_want, vjp = jax.vjp(lambda v: layer.apply({}, v, rngs={"dropout": k}), jnp.asarray(x, jd))
    (dx_want,) = vjp(jnp.asarray(g, jd))

    xt = torch.from_numpy(x).to(td).requires_grad_()
    y = port_dropout.dropout(xt, rate, random.fold_in_static(random.key(42), (1,)))
    y.backward(torch.from_numpy(g).to(td))
    assert y.dtype == td and xt.grad.dtype == td
    np.testing.assert_array_equal(_bits(y.detach().float()), _bits(jnp.asarray(y_want, jnp.float32)))
    np.testing.assert_array_equal(_bits(xt.grad.float()), _bits(jnp.asarray(dx_want, jnp.float32)))
    if 0.0 < rate < 1.0:
        kept = float((y != 0).float().mean())
        assert abs(kept - (1.0 - rate)) < 0.03


def test_bf16_divides_by_the_rounded_keep_probability():
    """JAX divides bf16 x by 0.9 rounded to bf16 (0.8984375), not by fp32 0.9."""
    x = torch.full((4096,), 1.5, dtype=torch.bfloat16)
    y, keep = port_dropout.reference_dropout_fwd(x, 0.1, random.key(0))
    want = (x.float() / 0.8984375).to(torch.bfloat16)
    assert torch.equal(y[keep], want[keep]) and bool(keep.any())


def test_backward_reads_the_forward_mask():
    """dx is dy / kp where the forward kept, 0 elsewhere: the VJP of the select."""
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    y, keep = port_dropout.dropout_fwd(x, 0.25, random.key(3))
    dy = torch.full_like(x, 3.0)
    dx = port_dropout.dropout_bwd(dy, keep, 0.25)
    assert torch.equal(dx != 0, keep) and bool(keep.any()) and not bool(keep.all())
    assert torch.equal(dx[keep], torch.full_like(dx[keep], 4.0))


@pytest.fixture
def meta_card(monkeypatch):
    """Meta tensors stand for CUDA tensors: the ``_is_cuda`` seam says yes
    and ``_launch`` records the call instead of launching."""
    calls = []
    monkeypatch.setattr(port_dropout, "_is_cuda", lambda t: True)
    monkeypatch.setattr(port_dropout, "_launch", lambda fn, *args, device: calls.append((fn, args)))
    return calls


def test_wrappers_launch_and_count_on_a_card(meta_card):
    before = (port_dropout.threefry_bits.launches, port_dropout.dropout_fwd.launches,
              port_dropout.dropout_bwd.launches)
    k = random.key(2**32 + 5)
    bits = port_dropout.threefry_bits(k, 10, offset=4, device="meta")
    assert bits.shape == (10,) and bits.dtype == torch.int32
    x = torch.empty((2, 8), dtype=torch.bfloat16, device="meta")
    y, mask = port_dropout.dropout_fwd(x, 0.1, k)
    assert y.shape == x.shape and mask.dtype == torch.uint8
    port_dropout.dropout_bwd(y, mask, 0.1)
    names = [c[0] for c in meta_card]
    assert names == ["smp_threefry_bits", "smp_dropout_fwd", "smp_dropout_bwd"]
    assert meta_card[0][1][1:] == (0, 5, 4, 10, 10, 10)  # key words, offset, n, one run of n
    fwd_args = meta_card[1][1]
    assert fwd_args[0] == 2 and fwd_args[4:10] == (0, 5, 16, 0, 16, 16)  # bf16; key, n; offset, run, stride
    assert fwd_args[10] == float(np.float32(0.9)) and fwd_args[11] == 0.8984375  # threshold, kp in bf16
    assert meta_card[2][1][0] == 2 and meta_card[2][1][4:] == (16, 0.8984375)  # bf16; n, kp
    after = (port_dropout.threefry_bits.launches, port_dropout.dropout_fwd.launches,
             port_dropout.dropout_bwd.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)


def test_wrappers_refuse_what_the_kernels_do_not_take(meta_card):
    with pytest.raises(TypeError, match="fp32, fp16 or bf16"):
        port_dropout.dropout_fwd(torch.empty(4, dtype=torch.float64, device="meta"), 0.1, random.key(0))
    x = torch.empty(4, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="forward's uint8 mask"):
        port_dropout.dropout_bwd(x, torch.empty(4, dtype=torch.bool, device="meta"), 0.1)
    with pytest.raises(TypeError, match="two uint32 words"):
        port_dropout.dropout(x, 0.1, torch.Generator())
    assert meta_card == []


def test_hidden_dropout_under_context_parallelism_raises(monkeypatch):
    """A rank's sequence shard would need its part of the global mask;
    until that is ported the smp.nn dispatch refuses and names the item."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.nn import utils as nn_utils

    monkeypatch.setattr(state, "cp_sharded", True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        nn_utils.dropout(torch.ones(2, 4), 0.1, random.key(0))
