"""The port's fp8 delayed-scaling machinery (``quant.py``) against the JAX
package's (``smdistributed_modelparallel_tpu/quant.py``).

The same numpy inputs from a seed go through both packages on the CPU:
  - the f32 -> float8_e4m3fn and -> float8_e5m2 casts, bit for bit, over a
    spread of magnitudes and every midpoint between neighbouring values of
    the format (the ties);
  - ``_cast_f8`` (true division by the slot's delayed scale, clip, cast) and
    ``_cast_e5m2_current`` (current scaling, an all-zero g included): exact;
  - ``finalize`` on fresh, partial and full histories with some slots
    unobserved, and ``QuantState.load_state_dict`` (slot-keyed, a foreign
    registry): exact, since both do the same fp32 divisions and maxima;
  - ``fp8_matmul`` forward and backward (dx, dw, db) under the same scales,
    ``n_contract`` 1 and 2, with and without bias, through the kernel's plain
    version (``use_pallas``, against the Pallas kernel in interpret mode) or
    the plain f8 product: the f8 operands are identical and each product of
    two f8 values is exact in fp32, so only the order of the fp32 sums
    differs: fp32 outputs within 1e-5 of their largest value; bf16 outputs
    within one bf16 ulp (rtol 2**-7) of it, as both round one fp32 value;
    the recorded amax observations are equal;
  - ``fake_quant`` forward (exact) and its straight-through gradient;
  - ``convert.quant_state_from_jax`` and ``matmul_precision_mode``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu import quant as jq
from smdistributed_modelparallel_tpu.backend.config import ModelParallelConfig as JaxConfig
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch import quant as pq
from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
from smdistributed_modelparallel_tpu_torch.convert import quant_state_from_jax

N_SLOTS = len(jq.SITE_SLOTS)
F8 = {"e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, jnp.float8_e4m3fn, 448.0),
      "e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2, jnp.float8_e5m2, 57344.0)}


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


def _jax_arrays(hist, scale):
    return {"amax_history": jnp.asarray(hist, jnp.float32), "scale": jnp.asarray(scale, jnp.float32)}


def _port_state(hist, scale):
    qs = pq.QuantState()
    qs.amax_history = torch.tensor(np.asarray(hist, np.float32))
    qs.scale = torch.tensor(np.asarray(scale, np.float32))
    return qs


def _bits(a):
    """uint8 codes of an f8 array (torch or jax)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _cast_sample(fmt, seed=0):
    """fp32 values: a spread from 1e-4 to the format's max over both signs,
    and every midpoint between neighbouring positive values of the format."""
    np_f8, _, _, fmax = F8[fmt]
    rng = np.random.default_rng(seed)
    spread = np.exp(rng.uniform(np.log(1e-4), np.log(fmax), 200_000)) * rng.choice([-1.0, 1.0], 200_000)
    codes = np.arange(256, dtype=np.uint8).view(np_f8).astype(np.float32)
    grid = np.unique(codes[np.isfinite(codes) & (codes >= 0)])
    mids = (grid[:-1].astype(np.float64) + grid[1:]) / 2
    return np.concatenate([spread, mids, -mids, grid, [0.0, -0.0]]).astype(np.float32)


@pytest.mark.parametrize("fmt", sorted(F8))
def test_f32_to_f8_cast_matches_jax_bit_for_bit(fmt):
    x = _cast_sample(fmt)
    _, t_f8, j_f8, _ = F8[fmt]
    got = _bits(torch.from_numpy(x).to(t_f8))
    want = _bits(jnp.asarray(x).astype(j_f8))
    np.testing.assert_array_equal(got, want)


def _scaled(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-4, 3, shape))).astype(np.float32)
    x.flat[::17] = 0.0
    return x if dtype == "fp32" else np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("scale", [1.0, 0.010045, 1.0 / 3.0, 0.5 / 448.0], ids=["fresh", "s0.010045", "s1_3", "clip"])
def test_cast_f8_matches_jax(scale, dtype):
    x = _scaled(1, (64, 50), dtype)
    sc = np.ones(N_SLOTS, np.float32)
    slot = "mlp_fc.x"
    sc[jq.SITE_SLOTS.index(slot)] = scale
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    with jq.step_trace(_jax_arrays(np.zeros((N_SLOTS, 16)), sc)):
        want, wd = jq._cast_f8(jnp.asarray(x, jd), slot)
    with pq.step_trace(_port_state(np.zeros((N_SLOTS, 16)), sc)):
        got, gd = pq._cast_f8(torch.from_numpy(x).to(td), slot)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(gd) == float(wd)


@pytest.mark.parametrize("case", ["normal", "all_zero", "bf16"])
def test_cast_e5m2_current_matches_jax(case):
    g = _scaled(2, (40, 30), "bf16" if case == "bf16" else "fp32") * 1e-3
    if case == "all_zero":
        g[:] = 0.0
    jd, td = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (jnp.float32, torch.float32)
    want, wd = jq._cast_e5m2_current(jnp.asarray(g, jd))
    got, gd = pq._cast_e5m2_current(torch.from_numpy(g).to(td))
    assert got.dtype == torch.float8_e5m2
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(gd) == float(wd)
    if case == "all_zero":
        assert float(gd) == 1.0


def _history(kind, seed):
    rng = np.random.default_rng(seed)
    hist = np.zeros((N_SLOTS, 16), np.float32)
    if kind == "partial":
        hist[:6, :3] = rng.uniform(0.01, 5.0, (6, 3))
    elif kind == "full":
        hist[:] = rng.uniform(0.001, 300.0, (N_SLOTS, 16))
    return hist


@pytest.mark.parametrize("kind", ["fresh", "partial", "full"])
def test_finalize_matches_jax(kind):
    hist = _history(kind, 3)
    scale = np.ones(N_SLOTS, np.float32)
    rng = np.random.default_rng(4)
    # Some slots observed (twice, so the running max matters), the rest not.
    observed = {s: rng.uniform(0.1, 9.0, 2).astype(np.float32) for s in jq.SITE_SLOTS[::3]}
    with jq.step_trace(_jax_arrays(hist, scale)) as jctx:
        for s, vals in observed.items():
            for v in vals:
                jctx.record(s, jnp.float32(v))
        want = jq.finalize(_jax_arrays(hist, scale))
    qs = _port_state(hist, scale)
    with pq.step_trace(qs) as pctx:
        for s, vals in observed.items():
            for v in vals:
                pctx.record(s, torch.tensor(v))
        got = pq.finalize(qs)
    np.testing.assert_array_equal(got["amax_history"].numpy(), np.asarray(want["amax_history"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    # Outside a trace nothing rolls; every scale comes from the history.
    np.testing.assert_array_equal(pq.finalize(qs)["amax_history"].numpy(), hist)


def test_load_state_dict_matches_jax_slot_keyed():
    rng = np.random.default_rng(5)
    slots = ["attn_k.x", "no_such_slot", "qkv.w", "mlp_fc.x"]
    sd = {"amax_history": rng.uniform(0.1, 3.0, (4, 8)).astype(np.float32),
          "scale": rng.uniform(0.001, 0.01, 4).astype(np.float32), "slots": slots}
    want = jq.QuantState()
    want.load_state_dict(sd)
    got = pq.QuantState()
    got.load_state_dict(sd)
    for key in ("amax_history", "scale"):
        np.testing.assert_array_equal(got.state_dict()[key], want.state_dict()[key])
    assert got.state_dict()["slots"] == want.state_dict()["slots"] == list(jq.SITE_SLOTS)
    assert pq.SITE_SLOTS == jq.SITE_SLOTS and pq.AMAX_HISTORY == jq.AMAX_HISTORY
    # A round trip through the port's own state dict.
    again = pq.QuantState()
    again.load_state_dict(got.state_dict())
    np.testing.assert_array_equal(again.state_dict()["amax_history"], got.state_dict()["amax_history"])


def test_quant_state_from_jax():
    qs = jq.QuantState()
    rng = np.random.default_rng(6)
    qs.amax_history = rng.uniform(0.0, 2.0, (N_SLOTS, 16)).astype(np.float32)
    qs.scale = rng.uniform(0.001, 1.0, N_SLOTS).astype(np.float32)
    port = pq.QuantState()
    port.load_state_dict(quant_state_from_jax(qs.state_dict()))
    np.testing.assert_array_equal(port.state_dict()["amax_history"], qs.amax_history)
    np.testing.assert_array_equal(port.state_dict()["scale"], qs.scale)
    bad = dict(qs.state_dict(), scale=qs.scale[:-1])
    with pytest.raises(ValueError, match="malformed"):
        quant_state_from_jax(bad)


# (x shape, JAX w shape, n_contract): the seams' einsum shapes, small.
MM_CASES = {
    "n_contract1": ((2, 5, 24), (24, 40), 1),
    "n_contract2_attn_proj": ((2, 5, 4, 6), (4, 6, 24), 2),
    "qkv_flat": ((12, 16), (16, 3, 2, 8), 1),
}


def _mm_inputs(case, dtype, seed):
    xs, ws, nc = MM_CASES[case]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(xs) * 2.0).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.05).astype(np.float32)
    F = int(np.prod(ws[nc:]))
    b = rng.standard_normal(F).astype(np.float32)
    g = (rng.standard_normal(xs[:len(xs) - nc] + ws[nc:]) * 1e-2).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    j = [jnp.asarray(a, jd) for a in (x, w, b, g)]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(td) for a in j]
    K = int(np.prod(ws[:nc]))
    t[1] = t[1].reshape(K, F).t().contiguous()  # the port's [F, K] nn.Linear layout
    t[3] = t[3].reshape(*xs[:len(xs) - nc], F)
    # Delayed scales that leave the operands in range but for a few clipped
    # elements of x (its scale puts |x| up to 1.2 x fmax).
    sc = np.ones(N_SLOTS, np.float32)
    sc[jq.SITE_SLOTS.index("qkv.x")] = np.abs(x).max() / 448.0 / 1.2
    sc[jq.SITE_SLOTS.index("qkv.w")] = np.abs(w).max() / 448.0
    return j, t, sc, (K, F)


def _close(got, want, dtype, name):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(got.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6 * scale, err_msg=name)


# The kernel rung is the fused QKV's (a 2-D x, n_contract 1); every case
# runs the plain f8 product.
MM_ROUTES = [(case, False) for case in sorted(MM_CASES)] + [
    (case, True) for case in sorted(MM_CASES) if MM_CASES[case][2] == 1]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("case, use_pallas", MM_ROUTES, ids=[f"{c}-{'kernel' if k else 'plain'}" for c, k in MM_ROUTES])
def test_fp8_matmul_matches_jax(case, use_pallas, bias, dtype):
    (jx, jw, jb, jg), (tx, tw, tb, tg), sc, (K, F) = _mm_inputs(case, dtype, 7 + len(case))
    nc = MM_CASES[case][2]
    hist = np.zeros((N_SLOTS, 16), np.float32)
    if use_pallas:  # the fused QKV's call: 2-D x and w
        jx, jw = jx.reshape(-1, K), jw.reshape(K, F)
        tx, tg, jg = tx.reshape(-1, K), tg.reshape(-1, F), jg.reshape(-1, F)
    jkw = dict(n_contract=nc, use_pallas=use_pallas, interpret=True)
    jargs = (jx, jw, jb) if bias else (jx, jw)
    with jq.step_trace(_jax_arrays(hist, sc)):
        y, vjp = jax.vjp(lambda *a: jq.fp8_matmul(a[0], a[1], "qkv", bias=a[2] if bias else None, **jkw), *jargs)
        want_grads = vjp(jg.reshape(y.shape).astype(y.dtype))
    with jq.step_trace(_jax_arrays(hist, sc)) as jctx:
        jq.fp8_matmul(*jargs[:2], "qkv", bias=jb if bias else None, **jkw)
        want_obs = {s: float(v) for s, v in jctx.pending.items()}
    targs = [a.requires_grad_() for a in ((tx, tw, tb) if bias else (tx, tw))]
    qs = _port_state(hist, sc)
    with pq.step_trace(qs) as pctx:
        out = pq.fp8_matmul(targs[0], targs[1], "qkv", bias=targs[2] if bias else None, n_contract=nc,
                            use_pallas=use_pallas)
        got_obs = {s: float(v) for s, v in pctx.observed.items()}
    got_grads = torch.autograd.grad(out, targs, tg)
    assert out.dtype == tx.dtype and out.shape == (*tx.shape[:tx.dim() - nc], F)
    assert got_obs == want_obs and set(got_obs) == {"qkv.x", "qkv.w"}
    _close(out, y, dtype, "y")
    for name, g, w in zip(("dx", "dw", "db"), got_grads, want_grads):
        assert g.dtype == targs[0].dtype, name
        w = np.asarray(jnp.asarray(w, jnp.float32))
        if name == "dw":
            w = w.reshape(K, F).T  # the port's weight is [F, K]
        _close(g, w, dtype, name)


def test_fp8_matmul_saves_f8_operands():
    """The backward keeps the f8 operands and the two scales, not copies of
    x and w in their own dtype."""
    (_, _, _, _), (tx, tw, tb, _), sc, _ = _mm_inputs("n_contract1", "bf16", 0)
    with pq.step_trace(_port_state(np.zeros((N_SLOTS, 16)), sc)):
        out = pq.fp8_matmul(tx.requires_grad_(), tw.requires_grad_(), "qkv", bias=tb.requires_grad_())
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert [t.dtype for t in saved] == [torch.float8_e4m3fn, torch.float32, torch.float8_e4m3fn, torch.float32]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fake_quant_matches_jax_straight_through(dtype):
    x = _scaled(8, (3, 7, 4, 8), dtype)
    g = _scaled(9, x.shape, dtype)
    sc = np.ones(N_SLOTS, np.float32)
    sc[jq.SITE_SLOTS.index("attn_q.x")] = np.abs(x).max() / 448.0
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    with jq.step_trace(_jax_arrays(np.zeros((N_SLOTS, 16)), sc)) as jctx:
        want = jq.fake_quant(jnp.asarray(x, jd), "attn_q.x")
        want_amax = float(jctx.pending["attn_q.x"])
    xt = torch.from_numpy(x).to(td).requires_grad_()
    with pq.step_trace(_port_state(np.zeros((N_SLOTS, 16)), sc)) as pctx:
        got = pq.fake_quant(xt, "attn_q.x")
        assert float(pctx.observed["attn_q.x"]) == want_amax
    assert got.dtype == td
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert not np.array_equal(got.detach().float().numpy(), xt.detach().float().numpy())  # it did round
    gt = torch.from_numpy(g).to(td)
    (grad,) = torch.autograd.grad(got, xt, gt)
    assert torch.equal(grad, gt)


def test_matmul_precision_mode_canonicalizes_as_jax():
    cases = [
        {},
        {"matmul_precision": "fp8"},
        {"matmul_precision": "fp8", "pipeline_parallel_degree": 2, "microbatches": 4},
        {"matmul_precision": "fp8", "sharded_params": "zero3", "ddp": True},
    ]
    for cfg in cases:
        assert pq.matmul_precision_mode(ModelParallelConfig(dict(cfg))) == jq.matmul_precision_mode(
            JaxConfig(dict(cfg))), cfg
    assert pq.matmul_precision_mode(None) == "bf16"
    smp_torch.init({"matmul_precision": "fp8"}, device="cpu")
    assert pq.matmul_precision_mode() == "fp8"


def test_trace_is_off_outside_a_step():
    assert not pq.fp8_trace_active()
    with pq.step_trace(None) as ctx:
        assert ctx is None and not pq.fp8_trace_active()
    with pq.step_trace(pq.QuantState()):
        assert pq.fp8_trace_active()
    assert not pq.fp8_trace_active()
    smp_torch.init({"matmul_precision": "fp8"}, device="cpu")
    qs = pq.ensure_state()
    assert pq.ensure_state() is qs and smp_torch.state.quant_state is qs
    smp_torch.reset()
    assert smp_torch.state.quant_state is None
