"""The port's context-parallel attention against the JAX package's.

The port's ``cp_attention`` (ring and Ulysses) runs in 2 (and once 4) CPU
processes over gloo, each holding its contiguous sequence shard, and is held
against:
  - the JAX package's ``cp_attention`` on its CPU mesh with the Pallas
    kernels in interpret mode (``FORCE_INTERPRET``), at cp = 2 and cp = 4:
    outputs and the gradients of sum(out * G);
  - the JAX package's chunked ring (``_RING_CHUNK`` patched so each shard
    splits into n_sub = 2 kernel calls) against the port's unchunked one,
    with key padding and dropout on;
  - full attention over the whole sequence (the port's plain flash path);
plus key padding, dropout equal across ring and Ulysses (one global hash),
the zigzag permutations and their round trip (in one process, over a
loopback group), and the online-softmax merge.

All ranks are spawned once per module (``chip_smoke.run_ranks``: the spawn
start method, a free port each time).
Tolerances, fp32: outputs 2e-5 and gradients 1e-4, as the JAX package's own
cp tests hold its ring against full attention (another summation order and
the online merge of per-block partials).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import run_ranks
import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.backend.state import state as jax_state
from smdistributed_modelparallel_tpu.ops import context_parallel as jax_cp
from smdistributed_modelparallel_tpu.ops import pallas_attention as jax_pa
from smdistributed_modelparallel_tpu_torch.ops import context_parallel as port_cp
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
B, T, H, HD = 2, 32, 4, 8
SCALE = 1.0 / np.sqrt(HD)


# ----------------------------------------------------------------------
# The cases, run by every rank on its shard
# ----------------------------------------------------------------------


def _data(seed=3):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, HD)).astype(np.float32) for _ in range(4))
    kpad = np.where(rng.random((B, T)) < 0.8, 0.0, -1e4).astype(np.float32)
    return q, k, v, g, kpad


# (name, impl, causal, kpad, dropout_rate); dropout seeds 77.
CASES = [
    ("ring_causal", "ring", True, False, 0.0),
    ("ring_noncausal", "ring", False, False, 0.0),
    ("ulysses_causal", "ulysses", True, False, 0.0),
    ("ulysses_noncausal", "ulysses", False, False, 0.0),
    ("ring_kpad", "ring", True, True, 0.0),
    ("ulysses_kpad", "ulysses", True, True, 0.0),
    ("ring_kpad_dropout", "ring", True, True, 0.2),
    ("ring_noncausal_kpad_dropout", "ring", False, True, 0.2),
    ("ulysses_kpad_dropout", "ulysses", True, True, 0.2),
]
CASES4 = [c for c in CASES if c[0] in ("ring_causal", "ulysses_causal", "ring_kpad_dropout")]


def _attention_worker(rank, world, cases):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.ops.context_parallel import cp_attention

    q, k, v, g, kpad = _data()
    Tl = T // world
    sl = slice(rank * Tl, (rank + 1) * Tl)
    out = {}
    for name, impl, causal, use_kpad, rate in cases:
        smp.init({"context_parallel_degree": world, "ddp": True, "context_parallel_impl": impl}, device="cpu")
        ql, kl, vl = (torch.tensor(x[:, sl], requires_grad=True) for x in (q, k, v))
        kp = torch.tensor(kpad[:, sl]) if use_kpad else None
        o = cp_attention(ql, kl, vl, scale=SCALE, causal=causal, kpad=kp, dropout_rate=rate,
                         seed=77 if rate else None)
        (o * torch.tensor(g[:, sl])).sum().backward()
        out[name] = [x.detach().numpy() for x in (o, ql.grad, kl.grad, vl.grad)]
    return out


@pytest.fixture(scope="module")
def port_runs():
    """{world: {case: [out, dq, dk, dv] over the whole sequence}}."""
    runs = {}
    for world, cases in ((2, CASES), (4, CASES4)):
        per_rank = run_ranks(world, _attention_worker, cases)
        runs[world] = {name: [np.concatenate([r[name][i] for r in per_rank], axis=1) for i in range(4)]
                       for name, *_ in cases}
    return runs


def _jax_cp(world, impl, causal, use_kpad, rate, chunk=None, monkeypatch=None):
    """[out, dq, dk, dv] of the JAX package's cp_attention on a cp = world
    mesh, the flash bodies in interpret mode."""
    q, k, v, g, kpad = _data()
    jax_pa.FORCE_INTERPRET = True
    if chunk is not None:
        monkeypatch.setattr(jax_cp, "_RING_CHUNK", chunk)
    jax_cp._ring_flash_fn.cache_clear()
    jax_cp._build_cp_call.cache_clear()
    try:
        jax_smp.reset()
        jax_smp.init({"context_parallel_degree": world, "ddp": True, "_device_count_override": world})
        kp = jnp.asarray(kpad) if use_kpad else None
        seed = jnp.int32(77) if rate else None

        def loss(q_, k_, v_):
            o = jax_cp.cp_attention(q_, k_, v_, scale=SCALE, causal=causal, impl=impl, kpad=kp,
                                    dropout_rate=rate, seed=seed)
            return jnp.sum(o * g), o

        with jax.set_mesh(jax_state.mesh):
            grads, o = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(x) for x in (o, *grads)]
    finally:
        jax_pa.FORCE_INTERPRET = False
        jax_cp._ring_flash_fn.cache_clear()
        jax_cp._build_cp_call.cache_clear()
        jax_smp.reset()


def _assert_close(got, want, what):
    names = ("out", "dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=OUT_TOL if name == "out" else GRAD_TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("world,name", [(2, "ring_causal"), (2, "ulysses_causal"), (2, "ulysses_kpad_dropout"),
                                        (4, "ring_causal"), (4, "ulysses_causal")])
def test_matches_jax_cp_attention(port_runs, world, name):
    case = next(c for c in CASES if c[0] == name)
    _assert_close(port_runs[world][name], _jax_cp(world, *case[1:]), f"cp={world} {name}")


@pytest.mark.parametrize("name", ["ring_kpad_dropout", "ring_noncausal_kpad_dropout"])
def test_unchunked_ring_matches_chunked_jax(port_runs, monkeypatch, name):
    """Tl = 16 with _RING_CHUNK = 8: the JAX ring makes n_sub = 2 kernel
    calls per step (4 in the backward); the port makes one."""
    calls = []
    orig = jax_pa.flash_fwd_with_ids
    monkeypatch.setattr(jax_pa, "flash_fwd_with_ids", lambda *a, **kw: calls.append(a[1].shape) or orig(*a, **kw))
    case = next(c for c in CASES if c[0] == name)
    want = _jax_cp(2, *case[1:], chunk=8, monkeypatch=monkeypatch)
    assert calls and all(s[1] == 8 for s in calls), calls
    _assert_close(port_runs[2][name], want, f"chunked {name}")


@pytest.mark.parametrize("world,name", [(2, n) for n, *_ in CASES if "dropout" not in n]
                         + [(4, "ring_causal"), (4, "ulysses_causal")])
def test_matches_full_attention(port_runs, world, name):
    _, impl, causal, use_kpad, _ = next(c for c in CASES if c[0] == name)
    q, k, v, g, kpad = _data()
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, _ = flash_attention(qt, kt, vt, torch.tensor(kpad) if use_kpad else None, scale=SCALE, causal=causal)
    (o * torch.tensor(g)).sum().backward()
    want = [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]
    _assert_close(port_runs[world][name], want, f"cp={world} {name} vs full attention")


@pytest.mark.parametrize("world", [2, 4])
def test_dropout_ring_equals_ulysses(port_runs, world):
    """One global hash: the ring and Ulysses drop the same probabilities,
    and dropout drops something."""
    if world == 2:
        _assert_close(port_runs[2]["ring_kpad_dropout"], port_runs[2]["ulysses_kpad_dropout"], "ring vs ulysses")
        assert not np.allclose(port_runs[2]["ring_kpad_dropout"][0], port_runs[2]["ring_kpad"][0])
    else:
        _assert_close(port_runs[4]["ring_kpad_dropout"], port_runs[2]["ring_kpad_dropout"], "cp=4 vs cp=2")


# ----------------------------------------------------------------------
# One process: zigzag layout and the merge rule
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_zig_perms_and_rows_match_jax(n):
    assert port_cp._zig_perms(n) == jax_cp._zig_perms(n)
    for dev in range(n):
        np.testing.assert_array_equal(port_cp._zig_rows(dev, 5, n).numpy(), np.asarray(jax_cp._zig_rows(dev, 5, n)))
    p1, p2 = port_cp._zig_perms(n)
    assert sorted(d for _, d in p1) == list(range(n)) and sorted(d for _, d in p2) == list(range(n))


class _Loopback:
    """Member ``index`` of an n-member group simulated in one process: a
    first pass records what every member sends, a second pass receives it
    (the zigzag exchanges never depend on what they receive)."""

    def __init__(self, index, size, sent):
        self.index, self.size, self.sent, self.calls = index, size, sent, 0

    def ppermute(self, xs, perm):
        key = self.calls
        self.calls += 1
        self.sent.setdefault(key, {})[self.index] = [x.clone() for x in xs]
        src = [s for s, d in perm if d == self.index]
        if not src or self.index not in self.sent.get(key, {}) or src[0] not in self.sent[key]:
            return [torch.zeros_like(x) for x in xs]
        return [x.clone() for x in self.sent[key][src[0]]]


def _simulate(fn, blocks):
    n, sent = len(blocks), {}
    for _ in range(2):
        outs = [fn([blocks[me]], me, n, _Loopback(me, n, sent))[0] for me in range(n)]
    return outs


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_round_trip(n):
    x = torch.arange(2 * 16 * n, dtype=torch.float32).reshape(2, 16 * n)
    Tl = 16
    natural = [x[:, me * Tl:(me + 1) * Tl] for me in range(n)]
    zig = _simulate(port_cp._zig_enter, natural)
    for me in range(n):
        np.testing.assert_array_equal(zig[me][0].numpy(), port_cp._zig_rows(me, Tl // 2, n).numpy())
    back = _simulate(port_cp._zig_exit, zig)
    for me in range(n):
        assert torch.equal(back[me], natural[me])


def test_merge_partial_matches_jax():
    """The online merge with sentinel rows (1e30: nothing visited) and
    all-masked rows (lse near -1e30), against the JAX package's."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((1, 6, 2, 4)).astype(np.float32)
    m_run = np.array([[[0.5, -1e30, 2.0, -1e30, 1.0, 3.0]] * 2], np.float32)
    z = np.array([[[1.5, 0.0, 2.0, 0.0, 1.0, 0.5]] * 2], np.float32)
    o_i = rng.standard_normal((1, 6, 2, 4)).astype(np.float32)
    lse_i = np.array([[[1.0, 0.3, 1e30, 1e30, -1e30 + 4.0, 2.5]] * 2], np.float32)
    want = jax_cp._merge_partial(*(jnp.asarray(a) for a in (u, m_run, z, o_i, lse_i)))
    got = port_cp._merge_partial(*(torch.tensor(a) for a in (u, m_run, z, o_i, lse_i)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    fin_w = jax_cp._finalize_merge(*want, jnp.float32)
    fin_g = port_cp._finalize_merge(*got, torch.float32)
    for a, b in zip(fin_g, fin_w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_allgather_impl_raises():
    with pytest.raises(NotImplementedError, match="allgather"):
        port_cp.cp_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                             scale=1.0, causal=True, impl="allgather", group=_Loopback(0, 2, {}))
