"""The port's ids-mode flash attention against the JAX package's.

``flash_fwd_with_ids_reference`` and the ids-mode backward's plain versions
(which the wrappers run for CPU tensors) are held against the JAX package's
``flash_fwd_with_ids`` and ``flash_bwd_with_ids`` with their Pallas kernels
in interpret mode, on the same numpy inputs: one (q block, kv block) pair of
a context-parallel ring step with the global zigzag ids of n = 2 and n = 4
ranks, causal and not, with key padding, dropout (seed, ``counter_len`` and
the ``head0``/``head_total`` remap), a pair whose every reference block is
skipped (output 0, the 1e30 lse sentinel), rows whose visited columns are all
masked (the mean of the visited v's, padding counted), odd lengths with
T != S, and bf16. The reference blocks are 32 wide here, so the per-block
runtime skip shows at these small shapes. The CUDA kernels run only on the
card: ``tests/test_torch_cuda_kernels.py`` holds them against these plain
versions.

Tolerances: fp32 runs the same arithmetic on both sides in another
summation order (one-pass against online softmax): 2e-5. bf16 rounds p and
ds to bf16 on both sides after fp32 sums in another order, so a rounding
flip moves a value by a bf16 ulp of its scale: 2e-2 of the largest value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smdistributed_modelparallel_tpu.ops import pallas_attention as jax_pa
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.ops.context_parallel import _zig_rows
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_bwd_dkv_ids,
    flash_bwd_dq_ids,
    flash_bwd_with_ids,
    flash_fwd_with_ids,
    flash_fwd_with_ids_reference,
)

FP32_TOL = 2e-5
BF16_REL_TOL = 2e-2
JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _zig(dev, Tl, n):
    return _zig_rows(dev, Tl // 2, n).numpy().astype(np.int32)


def _contig(dev, Tl):
    return (dev * Tl + np.arange(Tl)).astype(np.int32)


# (name, B, Tl, S, H, hd, q_ids, kv_ids, kwargs); blocks 32 x 32 unless named.
CASES = [
    ("zig2_diag_r0", 2, 64, 64, 2, 16, _zig(0, 64, 2), _zig(0, 64, 2), {}),
    ("zig2_off_r0", 2, 64, 64, 2, 16, _zig(0, 64, 2), _zig(1, 64, 2), {}),
    ("zig2_off_r1", 2, 64, 64, 2, 16, _zig(1, 64, 2), _zig(0, 64, 2), {}),
    ("zig2_diag_r1_noncausal", 2, 64, 64, 2, 16, _zig(1, 64, 2), _zig(1, 64, 2), dict(causal=False)),
    ("zig4_r1_src0", 1, 64, 64, 2, 16, _zig(1, 64, 4), _zig(0, 64, 4), {}),
    ("zig4_r1_src2", 1, 64, 64, 2, 16, _zig(1, 64, 4), _zig(2, 64, 4), {}),
    ("zig4_r2_src3_noncausal", 1, 64, 64, 2, 16, _zig(2, 64, 4), _zig(3, 64, 4), dict(causal=False)),
    ("zig2_kpad", 2, 64, 64, 2, 16, _zig(1, 64, 2), _zig(1, 64, 2), dict(kpad=True)),
    ("zig2_dropout_head_remap", 2, 64, 64, 2, 16, _zig(0, 64, 2), _zig(0, 64, 2),
     dict(seed=-7, dropout_rate=0.1, counter_len=128, head0=2, head_total=4)),
    ("all_blocks_skipped", 1, 64, 64, 2, 16, _contig(0, 64), _contig(1, 64), {}),
    ("all_masked_rows_average", 1, 64, 64, 2, 16, _zig(0, 64, 2), _zig(1, 64, 2),
     dict(block_q=128, block_k=128)),
    ("odd_t50_s70", 1, 50, 70, 2, 16, _contig(1, 50), _contig(0, 70) + 20, {}),
]


def _inputs(seed, B, T, S, H, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, hd), (B, S, H, hd), (B, S, H, hd), (B, T, H, hd)))


def _split(kw, B, S):
    kw = dict(kw)
    kw.setdefault("causal", True)
    kw.setdefault("block_q", 32)
    kw.setdefault("block_k", 32)
    kpad = None
    if kw.pop("kpad", False):
        kpad = np.zeros((B, S), np.float32)
        kpad[0, :40] = -1e30  # rows whose kept columns are all padded
        kpad[1, ::3] = -1e30
    return kw, kpad


def _jax_pair(q, k, v, g, kpad, qi, ki, dtype, kw):
    """(o, lse, dq, dk, dv) of the JAX package's ids-mode kernels, the
    backward fed the forward's o and lse."""
    cast = lambda x: jnp.asarray(x, JNP_DTYPE[dtype])  # noqa: E731
    kw = dict(kw, scale=0.3, interpret=True)
    if "seed" in kw:
        kw["seed"] = jnp.asarray(kw["seed"], jnp.int32)
    if "head0" in kw:
        kw["head0"] = jnp.asarray(kw["head0"], jnp.int32)
    kp = None if kpad is None else jnp.asarray(kpad)
    o, lse = jax_pa.flash_fwd_with_ids(cast(q), cast(k), cast(v), kp, jnp.asarray(qi), jnp.asarray(ki), **kw)
    o_in = o.astype(JNP_DTYPE[dtype])
    dq, dk, dv = jax_pa.flash_bwd_with_ids(cast(q), cast(k), cast(v), o_in, cast(g), lse, kp, jnp.asarray(qi),
                                           jnp.asarray(ki), **kw)
    return tuple(np.array(x, np.float32) for x in (o, lse, dq, dk, dv))


def _close(got, want, dtype, what):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_TOL, err_msg=what)
    else:
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got - want).max()) <= BF16_REL_TOL * scale, what


# fp32 on every case; bf16 on the main path's pairs and the kpad pair.
PARAMS = [(c, "float32") for c in CASES] + [
    (c, "bfloat16") for c in CASES if c[0] in ("zig2_diag_r0", "zig2_off_r1", "zig2_kpad")]


@pytest.mark.parametrize("case,dtype", PARAMS, ids=[f"{c[0]}-{d}" for c, d in PARAMS])
def test_ids_pair_matches_pallas_interpret(case, dtype):
    name, B, T, S, H, hd, qi, ki, kw = case
    q, k, v, g = _inputs(len(name), B, T, S, H, hd)
    kw, kpad = _split(kw, B, S)
    o_j, lse_j, dq_j, dk_j, dv_j = _jax_pair(q, k, v, g, kpad, qi, ki, dtype, kw)

    t = lambda x: torch.from_numpy(x).to(TORCH_DTYPE[dtype])  # noqa: E731
    qt, kt, vt, gt = t(q), t(k), t(v), t(g)
    kp = None if kpad is None else torch.from_numpy(kpad)
    qit, kit = torch.from_numpy(qi), torch.from_numpy(ki)
    o, lse = flash_fwd_with_ids(qt, kt, vt, kp, qit, kit, scale=0.3, **kw)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    _close(o, o_j, dtype, "o")
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=1e-6, atol=1e-5 if dtype == "float32" else 1e-3)
    o_in = torch.from_numpy(o_j).to(TORCH_DTYPE[dtype])
    grads = flash_bwd_with_ids(qt, kt, vt, o_in, gt, torch.from_numpy(lse_j), kp, qit, kit, scale=0.3, **kw)
    for what, got, want in zip(("dq", "dk", "dv"), grads, (dq_j, dk_j, dv_j)):
        assert got.dtype == torch.float32
        _close(got, want, dtype, what)


def test_skipped_pair_is_zero_with_the_sentinel():
    q, k, v, _ = _inputs(0, 1, 64, 64, 2, 16)
    t = torch.from_numpy
    o, lse = flash_fwd_with_ids(t(q), t(k), t(v), None, t(_contig(0, 64)), t(_contig(1, 64)), scale=0.3,
                                causal=True, block_q=32, block_k=32)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full_like(lse, 1e30))


def test_reference_block_granularity_shows_in_all_masked_rows():
    """Rows 0..31 of rank 0's zigzag block see only later ids in rank 1's
    kv block: at 128-wide reference blocks the block is visited (their
    output is the mean of the visited v's), at 32-wide ones it is skipped
    (output 0): the skip is decided per reference block, not per tile."""
    q, k, v, _ = _inputs(1, 1, 64, 64, 2, 16)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), None, t(_zig(0, 64, 2)), t(_zig(1, 64, 2)))
    wide, lse_w = flash_fwd_with_ids_reference(*args, scale=0.3, causal=True, block_q=128, block_k=128)
    narrow, lse_n = flash_fwd_with_ids_reference(*args, scale=0.3, causal=True, block_q=32, block_k=32)
    torch.testing.assert_close(wide[0, :32], t(v)[0].mean(0, keepdim=True).expand(32, -1, -1) * 64 / 128)
    assert torch.equal(narrow[0, :32], torch.zeros_like(narrow[0, :32]))
    assert bool((lse_n[0, :, :32] == 1e30).all()) and bool((lse_w[0, :, :32] < -1e29).all())


def test_backward_wrappers_split_as_the_composite():
    q, k, v, g = _inputs(2, 2, 64, 64, 2, 16)
    t = torch.from_numpy
    ids = t(_zig(1, 64, 2)), t(_zig(0, 64, 2))
    kw = dict(scale=0.3, causal=True)
    o, lse = flash_fwd_with_ids(t(q), t(k), t(v), None, *ids, **kw)
    dq, dk, dv = flash_bwd_with_ids(t(q), t(k), t(v), o, t(g), lse, None, *ids, **kw)
    delta = attention_delta(o, t(g))
    assert torch.equal(dq, flash_bwd_dq_ids(t(q), t(k), t(v), t(g), lse, delta, None, *ids, **kw))
    dk2, dv2 = flash_bwd_dkv_ids(t(q), t(k), t(v), t(g), lse, delta, None, *ids, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_ids_default_reference_block_is_256():
    """The ids entry points resolve kv blocks with default_k=256, not the
    512 of flash_attention: at S = 384 the last 128 columns form their own
    block, skipped for rows whose ids are all below theirs."""
    q, k, v, _ = _inputs(3, 1, 384, 384, 1, 16)
    t = torch.from_numpy
    qi = np.arange(384, dtype=np.int32)
    ki = np.concatenate([np.arange(256), np.arange(1000, 1128)]).astype(np.int32)
    o, lse = flash_fwd_with_ids(t(q), t(k), t(v), None, t(qi), t(ki), scale=0.3, causal=True)
    kw = dict(scale=0.3, causal=True, interpret=True)
    o_j, lse_j = jax_pa.flash_fwd_with_ids(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, jnp.asarray(qi),
                                           jnp.asarray(ki), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-6, atol=1e-5)
