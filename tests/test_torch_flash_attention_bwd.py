"""The port's flash-attention backward against the JAX package's.

The plain backward (``flash_attention_bwd_reference``, which the wrappers
run for CPU tensors) is held against ``jax.vjp`` of the JAX package's
``flash_attention`` with its Pallas kernels in interpret mode, on the same
numpy inputs and output gradient: dq, dk and dv over every feature of the
TPU backward kernels (T != S, sentinel rows, non-causal, causal and
symmetric windows, kpad with left- and fully-padded rows, dropout with the
head remap and negative seeds, hd 48..128, ragged T). The CUDA kernels run
only on the card: ``tests/test_torch_cuda_kernels.py`` holds them against
this plain version.

Tolerances: fp32 runs the same arithmetic on both sides; the forward's LSE
(from the blockwise online softmax on the TPU side) and the summation order
differ, so grads agree to 1e-4. bf16 rounds ds and p to bf16 on both sides
and the outputs to bf16, so a rounding flip moves a grad by a bf16 ulp of
its scale: 2e-2 of the largest grad.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smdistributed_modelparallel_tpu.ops import pallas_attention as jax_pa
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.ops import attention as port_attention
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)

FP32_TOL = 1e-4
BF16_REL_TOL = 2e-2
JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _inputs(seed, B, T, S, H, hd):
    """q, k, v and the output gradient dO, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, T, H, hd), (B, S, H, hd), (B, S, H, hd), (B, T, H, hd))
    )


def _kpad_left_and_full(B, S):
    kpad = np.zeros((B, S), np.float32)
    kpad[1, :50] = -1e30  # left padding: rows < 50 see only pad keys
    kpad[2, :] = -1e30    # a fully padded sequence
    return kpad


def _jax_grads(q, k, v, do, dtype, kpad=None, seed=None, scale=None,
               causal=True, window=None, dropout_rate=0.0, block_q=None,
               block_k=None, head0=None, head_total=None, counter_len=None):
    """dq, dk, dv of the JAX package's flash_attention (custom_vjp, Pallas
    interpret mode)."""
    cast = lambda x: jnp.asarray(x, JNP_DTYPE[dtype])  # noqa: E731
    kp = None if kpad is None else jnp.asarray(kpad)
    sd = None if seed is None else jnp.asarray(seed, jnp.int32)

    def f(q_, k_, v_):
        return jax_pa.flash_attention(
            q_, k_, v_, kp, sd, head0, scale, causal, window, dropout_rate,
            block_q, block_k, True, head_total, counter_len,
        )

    _, vjp = jax.vjp(f, cast(q), cast(k), cast(v))
    return tuple(np.asarray(g.astype(jnp.float32)) for g in vjp(cast(do)))


def _port_grads(q, k, v, do, dtype, kpad=None, **kw):
    cast = lambda x: torch.from_numpy(x).to(TORCH_DTYPE[dtype])  # noqa: E731
    qt, kt, vt, dot = cast(q), cast(k), cast(v), cast(do)
    kp = None if kpad is None else torch.from_numpy(kpad)
    o, lse = flash_attention_reference(qt, kt, vt, kp, **kw)
    grads = flash_attention_bwd_reference(qt, kt, vt, o, dot, lse, kp, **kw)
    return tuple(g.float().numpy() for g in grads)


# (B, T, S, H, hd, kwargs): every feature of the TPU backward kernels.
CASES = {
    "causal": (2, 160, 160, 2, 32, {}),
    "causal_t_lt_s": (2, 130, 200, 2, 32, {}),
    "causal_t_gt_s_sentinel_rows": (1, 300, 130, 2, 32, dict(block_q=128, block_k=128)),
    "non_causal": (2, 150, 190, 2, 32, dict(causal=False)),
    "causal_window": (1, 300, 300, 2, 32, dict(window=70, block_q=128, block_k=128)),
    "symmetric_window": (1, 200, 260, 2, 32, dict(causal=False, window=50, block_q=128, block_k=128)),
    "kpad_fully_padded_rows": (3, 160, 160, 2, 32, dict(kpad="left_and_full")),
    "kpad_multi_block": (3, 260, 260, 2, 32, dict(kpad="left_and_full", block_q=128, block_k=128)),
    "dropout": (2, 160, 160, 2, 32, dict(dropout_rate=0.1, seed=-123456789)),
    "dropout_head_remap": (1, 140, 140, 2, 32, dict(dropout_rate=0.25, seed=77, head0=3,
                                                    head_total=8, counter_len=1000)),
    "dropout_negative_seed_non_causal": (1, 130, 150, 2, 32, dict(causal=False, dropout_rate=0.5,
                                                                  seed=-2**31)),
    "hd64": (1, 130, 130, 2, 64, {}),
    "hd128_scale": (1, 130, 130, 2, 128, dict(scale=0.05)),
    "ragged_t200_hd48": (1, 200, 200, 2, 48, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_kernels_fp32(case):
    B, T, S, H, hd, kw = CASES[case]
    kw = dict(kw)
    q, k, v, do = _inputs(zlib.crc32(case.encode()), B, T, S, H, hd)
    kpad = _kpad_left_and_full(B, S) if kw.pop("kpad", None) else None
    want = _jax_grads(q, k, v, do, "float32", kpad=kpad, **kw)
    got = _port_grads(q, k, v, do, "float32", kpad=kpad, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=FP32_TOL, atol=FP32_TOL, err_msg=name)


@pytest.mark.parametrize("case", ["causal", "kpad_fully_padded_rows", "dropout_head_remap"])
def test_plain_backward_matches_jax_kernels_bf16(case):
    B, T, S, H, hd, kw = CASES[case]
    kw = dict(kw)
    q, k, v, do = _inputs(zlib.crc32(case.encode()) + 1, B, T, S, H, hd)
    kpad = _kpad_left_and_full(B, S) if kw.pop("kpad", None) else None
    want = _jax_grads(q, k, v, do, "bfloat16", kpad=kpad, **kw)
    got = _port_grads(q, k, v, do, "bfloat16", kpad=kpad, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= BF16_REL_TOL * np.abs(w).max(), name


def test_fully_masked_rows_reproduce_the_tpu_arithmetic():
    """A fully padded sequence: the forward's LSE is -1e30, and every kept
    pair scores -1e30 too, so p = exp(0) = 1 there and the grads are
    nonzero, as the TPU kernels compute them."""
    B, T, S, H, hd = 3, 160, 160, 2, 32
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, B, T, S, H, hd))
    kpad = torch.from_numpy(_kpad_left_and_full(B, S))
    o, lse = flash_attention_reference(q, k, v, kpad)
    assert (lse[2] == np.float32(-1e30)).all()
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, do, lse, kpad)
    assert dq[2].abs().max() > 0 and dv[2].abs().max() > 0
    # dv of the padded sequence: column c gathers dO of every row r >= c.
    want_dv = torch.flip(torch.cumsum(torch.flip(do[2], [0]), 0), [0])
    torch.testing.assert_close(dv[2], want_dv, rtol=1e-5, atol=1e-4)


def test_autograd_function_returns_the_plain_backward():
    """On the CPU, flash_attention's autograd.Function runs the plain
    backward exactly: the same grads, bit for bit."""
    B, T, S, H, hd = 2, 140, 170, 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, B, T, S, H, hd))
    kw = dict(dropout_rate=0.2, seed=31, head0=1, head_total=4)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = flash_attention(qs, ks, vs, **kw)
    assert o.grad_fn is not None and not lse.requires_grad
    o.backward(do)
    o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
    assert torch.equal(o.detach(), o_ref) and torch.equal(lse, lse_ref)
    want = flash_attention_bwd_reference(q, k, v, o_ref, do, lse_ref, **kw)
    for g, w in zip((qs.grad, ks.grad, vs.grad), want):
        assert torch.equal(g, w)
    assert flash_attention_bwd(q, k, v, o_ref, do, lse_ref, **kw)[0].equal(want[0])


def test_kernel_wrappers_run_the_plain_version_on_cpu():
    B, T, S, H, hd = 1, 130, 130, 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, B, T, S, H, hd))
    o, lse = flash_attention_reference(q, k, v)
    delta = attention_delta(o, do)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
    want = flash_attention_bwd_reference(q, k, v, o, do, lse)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)


def test_delta_is_rowsum_of_do_times_o():
    rng = np.random.default_rng(3)
    o, do = (rng.standard_normal((2, 5, 3, 4)).astype(np.float32) for _ in range(2))
    got = attention_delta(torch.from_numpy(o), torch.from_numpy(do)).numpy()
    np.testing.assert_allclose(got, (o * do).sum(-1).transpose(0, 2, 1), rtol=1e-6)


def test_backward_matches_autograd_of_plain_forward_on_live_rows():
    """Where no row is fully masked, the TPU backward is the exact gradient
    of the forward: autograd through the plain forward agrees."""
    B, T, S, H, hd = 2, 130, 150, 2, 16
    q, k, v, do = (torch.from_numpy(x).double().float() for x in _inputs(13, B, T, S, H, hd))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    o, _ = flash_attention_reference(qs, ks, vs, causal=False, window=40)
    o.backward(do)
    o_ref, lse = flash_attention_reference(q, k, v, causal=False, window=40)
    got = flash_attention_bwd_reference(q, k, v, o_ref, do, lse, causal=False, window=40)
    for g, w in zip(got, (qs.grad, ks.grad, vs.grad)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_core_plain_dropout_matches_jax(rate):
    """The plain path's attention dropout (T < 128, or any CPU tensor):
    ``bernoulli(key, 1 - rate)`` over the [B, H, T, S] probabilities, as the
    JAX package's jnp path draws it, with the same key on both sides: the
    output and its gradients agree in fp32 (summation order only)."""
    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.ops import attention as jax_attention
    from smdistributed_modelparallel_tpu_torch.utils import random

    q, k, v, do = _inputs(17, 2, 40, 40, 2, 16)
    jkey = jax.random.fold_in(jax.random.key(5), 3)

    def jax_fn(q_, k_, v_):
        return jax_attention.attention_core(q_, k_, v_, dropout_rate=rate, dropout_rng=jkey)

    jax_smp.init({})  # a default session: no cp left over from another test
    try:
        want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
        want_grads = vjp(jnp.asarray(do))
    finally:
        jax_smp.reset()
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = port_attention.attention_core(*ts, dropout_rate=rate,
                                        dropout_rng=random.as_key(np.asarray(jax.random.key_data(jkey))))
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=FP32_TOL)
    # Without the key, or at rate 0, there is no dropout.
    plain = port_attention.attention_core(*(t.detach() for t in ts))
    for kw in (dict(dropout_rate=rate), dict(dropout_rate=0.0, dropout_rng=random.key(1))):
        torch.testing.assert_close(port_attention.attention_core(*(t.detach() for t in ts), **kw), plain,
                                   rtol=0, atol=0)