"""The port's flash-attention forward against the JAX package's.

The plain PyTorch version (``flash_attention_reference``, which the wrapper
runs for CPU tensors) is held against the JAX forward kernel run in Pallas
interpret mode on the same numpy inputs: O and LSE over every feature of the
kernel, including the rows with no kept column and the dropout hash, whose
keep bits must be identical. ``attention_core``'s plain path is held against
the JAX package's jnp path. The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda_kernels.py`` holds it against this plain version.

Tolerances: fp32 inputs run the same fp32 arithmetic on both sides; only the
summation order and the TPU kernel's blockwise (online) softmax differ, so
O and LSE agree to 2e-5. bf16 inputs round P to bf16 against different row
maxima (the TPU kernel's running max, the plain version's final one), so O
agrees to 2e-2 while LSE, computed in fp32, stays at 1e-4.
"""

import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smdistributed_modelparallel_tpu.ops import attention as jax_attention
from smdistributed_modelparallel_tpu.ops import pallas_attention as jax_pa
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.ops import attention as port_attention
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
    dropout_keep,
    flash_attention,
    flash_attention_reference,
)

TOL = {
    "float32": dict(o=2e-5, lse=2e-5),
    "bfloat16": dict(o=2e-2, lse=1e-4),
}
JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this file's tensors are small, so torch's thread
    pool costs more than it gives (8 threads took 25x longer than one for
    the dropout hash), and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _inputs(seed, B, T, S, H, hd):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, T, H, hd), (B, S, H, hd), (B, S, H, hd))
    )


def _jax_fwd(q, k, v, dtype, kpad=None, seed=None, scale=None, causal=True,
             window=None, dropout_rate=0.0, block_q=None, block_k=None,
             head0=None, head_total=None, counter_len=None):
    """The JAX forward kernel in interpret mode: (o, lse [B, H, T])."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    if scale is None:
        scale = 1.0 / np.sqrt(hd)
    bq, bk = jax_pa.resolve_blocks(block_q, block_k)
    bq, bk = jax_pa._clamp_block(bq, T), jax_pa._clamp_block(bk, S)
    cast = lambda x: jnp.asarray(x, JNP_DTYPE[dtype])  # noqa: E731
    o, lse = jax_pa._flash_fwd_impl(
        cast(q), cast(k), cast(v),
        None if kpad is None else jnp.asarray(kpad),
        None if seed is None else jnp.asarray(seed, jnp.int32),
        scale, causal, window, dropout_rate, bq, bk, True,
        head0=head0, head_total=head_total, counter_len=counter_len,
    )
    lse = np.asarray(lse)[:, 0, :T].reshape(B, H, T)
    return np.asarray(o.astype(jnp.float32)), lse


def _port_fwd(q, k, v, dtype, kpad=None, **kw):
    cast = lambda x: torch.from_numpy(x).to(TORCH_DTYPE[dtype])  # noqa: E731
    o, lse = flash_attention(
        cast(q), cast(k), cast(v),
        None if kpad is None else torch.from_numpy(kpad), **kw,
    )
    return o.float().numpy(), lse.numpy()


def _kpad_left_and_full(B, S):
    kpad = np.zeros((B, S), np.float32)
    kpad[1, :50] = -1e30  # left padding: rows < 50 see only pad keys
    kpad[2, :] = -1e30    # a fully padded sequence
    return kpad


# (B, T, S, H, hd, kwargs): every feature of the TPU forward kernel.
CASES = {
    "causal": (2, 160, 160, 4, 32, {}),
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
    "hd128_scale": (1, 130, 130, 2, 128, dict(scale=0.05)),
    "ragged_t200_hd48": (1, 200, 200, 2, 48, {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case, dtype):
    B, T, S, H, hd, kw = CASES[case]
    kw = dict(kw)
    q, k, v = _inputs(zlib.crc32(case.encode()), B, T, S, H, hd)
    kpad = _kpad_left_and_full(B, S) if kw.pop("kpad", None) else None
    o_jax, lse_jax = _jax_fwd(q, k, v, dtype, kpad=kpad, **kw)
    o, lse = _port_fwd(q, k, v, dtype, kpad=kpad, **kw)
    tol = TOL[dtype]
    np.testing.assert_allclose(o, o_jax, rtol=0, atol=tol["o"])
    np.testing.assert_allclose(lse, lse_jax, rtol=0, atol=tol["lse"])


def test_sentinel_and_fully_masked_rows():
    """Rows with no visited column: O = 0 and LSE = 1e30; rows whose visited
    columns are all masked: LSE = -1e30 and O = mean of the visited v's."""
    B, T, S, H, hd, kw = CASES["causal_t_gt_s_sentinel_rows"]
    q, k, v = _inputs(0, B, T, S, H, hd)
    o, lse = _port_fwd(q, k, v, "float32", **kw)
    # Reference q block 0 (rows 0..127) sees no kv block at offset -170.
    assert (lse[:, :, :128] == np.float32(1e30)).all()
    assert (o[:, :128] == 0).all()
    # Rows 128..169 visit kv block 0 (cols 0..127) but keep none of it.
    assert (lse[:, :, 128:170] == np.float32(-1e30)).all()
    np.testing.assert_allclose(o[:, 128:170], np.broadcast_to(v[:, :128].mean(1, keepdims=True), o[:, 128:170].shape),
                               atol=1e-5)
    assert np.isfinite(lse[:, :, 170:]).all() and (np.abs(lse[:, :, 170:]) < 1e3).all()


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9999999])
def test_dropout_keep_bits_identical(rate):
    """The JAX hash is compiled once a (s_total, rate) instead of dispatched
    op by op: integer arithmetic, the same bits either way."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 4096, 256).astype(np.int32)[:, None]
    cols = rng.integers(0, 4096, 256).astype(np.int32)[None, :]
    jax_keep = jax.jit(jax_pa._dropout_keep, static_argnums=(4, 5))
    for seed in (0, 1, -1, -2**31, 2**31 - 1, 123456789):
        for bh in (0, 5, 47, 1023):
            for s_total in (128, 512, 1000, 8192):
                want = np.asarray(jax_keep(
                    jnp.asarray(seed, jnp.int32), jnp.asarray(bh, jnp.int32), jnp.asarray(rows),
                    jnp.asarray(cols), s_total, rate))
                got = dropout_keep(seed, torch.tensor(bh), torch.from_numpy(rows).long(),
                                   torch.from_numpy(cols).long(), s_total, rate).numpy()
                np.testing.assert_array_equal(got, want)


def test_cpu_wrapper_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 128, 128, 2, 16))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v)
    o_ref, lse_ref = flash_attention_reference(q, k, v)
    assert flash_attention.launches == before
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


def test_block_sizes_follow_config():
    """The reference tiling resolves as the JAX package's does: the config's
    pallas_attn_block_q/k decide the default dropout stride."""
    q, k, v = _inputs(2, 1, 600, 600, 1, 8)
    smp_torch.init({"pallas_attn_block_k": 128})
    o_cfg, _ = _port_fwd(q, k, v, "float32", dropout_rate=0.3, seed=5)
    smp_torch.reset()
    o_arg, _ = _port_fwd(q, k, v, "float32", dropout_rate=0.3, seed=5, block_k=128)
    o_def, _ = _port_fwd(q, k, v, "float32", dropout_rate=0.3, seed=5)
    np.testing.assert_array_equal(o_cfg, o_arg)
    assert not np.array_equal(o_cfg, o_def)  # s_pad 640 vs 1024: another hash stride


def _gate_inputs(T, S, hd, dtypes=("float32",) * 3, cuda=True):
    shapes = ((1, T, 2, hd), (1, S, 2, hd), (1, S, 2, hd))
    port = [SimpleNamespace(is_cuda=cuda, shape=s, dtype=TORCH_DTYPE[d]) for s, d in zip(shapes, dtypes)]
    jax_ = [jnp.zeros(s, JNP_DTYPE[d]) for s, d in zip(shapes, dtypes)]
    return port, jax_


@pytest.mark.parametrize("T,S,hd", [
    (128, 128, 64), (127, 128, 64), (128, 127, 64), (8192, 8192, 64), (8193, 128, 64),
    (128, 8193, 64), (512, 512, 256), (512, 512, 257), (1, 544, 64),
])
def test_kernel_gate_matches_jax_gate(monkeypatch, T, S, hd):
    """Both packages send the same calls to their kernel: the port's gate
    with "q is a CUDA tensor" equals ``_pallas_ok`` on a TPU."""
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("SMP_DISABLE_PALLAS_ATTN", raising=False)
    port, jx = _gate_inputs(T, S, hd)
    assert port_attention._kernel_ok(*port) == jax_attention._pallas_ok(*jx)
    port, jx = _gate_inputs(T, S, hd, dtypes=("bfloat16", "bfloat16", "float32"))
    assert port_attention._kernel_ok(*port) == jax_attention._pallas_ok(*jx) is False
    monkeypatch.setenv("SMP_DISABLE_PALLAS_ATTN", "1")
    port, jx = _gate_inputs(T, S, hd)
    assert port_attention._kernel_ok(*port) == jax_attention._pallas_ok(*jx) is False


def test_kernel_gate_needs_cuda():
    port, _ = _gate_inputs(512, 512, 64, cuda=False)
    assert not port_attention._kernel_ok(*port)


# attention_core's plain path vs the JAX package's jnp path (both packages
# take it on the CPU), fp32: same arithmetic, summation order aside.
CORE_CASES = {
    "causal": (2, 9, 9, dict()),
    "causal_window": (2, 12, 12, dict(window=4)),
    "non_causal_window": (1, 7, 11, dict(causal=False, window=3)),
    "decode_bool_mask": (2, 1, 16, dict(causal=False, mask="decode")),
    "additive_kpad_mask": (2, 6, 6, dict(mask="additive")),
    "bias": (1, 5, 5, dict(bias=True)),
    "fp32_attention_long": (1, 130, 130, dict(attention_in_fp32=True)),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_attention_core_matches_jnp_path(case):
    B, T, S, kw = CORE_CASES[case]
    kw = dict(kw)
    H, hd = 2, 8
    q, k, v = _inputs(3, B, T, S, H, hd)
    rng = np.random.default_rng(4)
    jax_kw, port_kw = dict(kw), dict(kw)
    if kw.get("mask") == "decode":
        keep = np.arange(S) <= 9  # the decode cache's col <= index mask
        jax_kw["mask"] = jnp.asarray(keep)[None, None, None, :]
        port_kw["mask"] = torch.from_numpy(keep)[None, None, None, :]
    elif kw.get("mask") == "additive":
        add = np.where(rng.random((B, 1, 1, S)) < 0.3, -1e4, 0.0).astype(np.float32)
        jax_kw["mask"], port_kw["mask"] = jnp.asarray(add), torch.from_numpy(add)
    if kw.get("bias"):
        bias = rng.standard_normal((1, H, T, S)).astype(np.float32)
        jax_kw["bias"], port_kw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    want = np.asarray(jax_attention.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jax_kw))
    got = port_attention.attention_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **port_kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
