"""The port's ``smp.serving.ServingEngine`` against the JAX package's engine.

The JAX engine's composite (continuous batching on a tight pool, a multi-
chunk prompt, an EOS stop that frees its blocks at once, seeded sampling with
top-k and top-p) runs on both engines from the same converted weights, with
rotary and with learned positions, in one module-scoped run each. The port
must give the JAX engine's tokens token for token, the same ``stats`` and
``mirror_log``, and pools that agree after ``convert.kv_pools_to_jax`` to
1e-5 of their largest value (fp32; the two packages sum in other orders, so
the pools cannot be bit-equal; the conversion itself round-trips bit for
bit). Each stream must also equal the port's ``smp.generate`` at batch 1.
The rest holds the engine's protocol (validation, idempotency, resumed
requests, drain, live weight adoption) and every refusal. The int8 knobs
run in ``tests/test_torch_int8_serving.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smdistributed_modelparallel_tpu as smp_jax
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.serving import ServeRequest as JaxServeRequest
from smdistributed_modelparallel_tpu.serving import ServingEngine as JaxServingEngine
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch import serving
from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.convert import kv_pools_from_jax, kv_pools_to_jax, params_from_jax
from smdistributed_modelparallel_tpu_torch.models.gpt2 import init_gpt2_weights_
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.serving import (
    ServeRequest,
    ServingEngine,
    serve_request_from_record,
    serve_request_to_record,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPRuntimeError, SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.random import key

SMALL = dict(vocab_size=97, max_len=64, d_model=32, n_layers=2, n_heads=4)
TIGHT = dict(max_slots=3, num_blocks=13, block_tokens_override=4, prefill_chunk=4)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _prompt(seed, length):
    return list(map(int, np.random.default_rng(seed).integers(0, SMALL["vocab_size"], length)))


# The composite's three batches: ragged greedy (g1's 11 tokens take 3 prefill
# chunks), then an EOS stop beside a long stream, then seeded sampling.
GREEDY = [("g0", _prompt(10, 7), 6), ("g1", _prompt(11, 11), 4), ("g2", _prompt(12, 3), 9),
          ("g3", _prompt(13, 5), 5), ("g4", _prompt(14, 9), 7)]
STOCH = [("t0", _prompt(30, 5), 7, dict(temperature=1.0, seed=3)),
         ("t1", _prompt(31, 8), 6, dict(temperature=0.8, top_k=11, seed=9)),
         ("t2", _prompt(32, 6), 8, dict(temperature=1.2, top_p=0.85, seed=4)),
         ("t3", _prompt(33, 7), 5, dict(temperature=0.7, top_k=9, top_p=0.9, seed=8))]
EOS_PROMPT, LONG_PROMPT = _prompt(20, 6), _prompt(21, 6)


def _generate(model, prompt, max_new, **kw):
    """The port's smp.generate at batch 1: the parity oracle of a stream."""
    out = smp_torch.generate(model, torch.tensor([prompt]), max_new, **kw)
    return [int(t) for t in out[0, len(prompt):]]


def _truncate_at_eos(tokens, eos):
    out = []
    for t in tokens:
        out.append(int(t))
        if int(t) == eos:
            break
    return out


def _run_composite(engine, make_request, eos, on_tick=None):
    """Drive one engine through the three batches; returns its program count
    and decode steps after the first."""
    engine.run([make_request(rid, p, m) for rid, p, m in GREEDY], timeout_s=300)
    after_greedy = len(engine._programs), engine.stats["decode_steps"]
    engine.submit(make_request("long", LONG_PROMPT, 12))
    engine.submit(make_request("eos", EOS_PROMPT, 8, eos_token_id=eos))
    while engine.busy:
        engine.step()
        if on_tick is not None:
            on_tick(engine)
    engine.run([make_request(rid, p, m, **kw) for rid, p, m, kw in STOCH], timeout_s=300)
    return after_greedy


@pytest.fixture(scope="module", params=["rotary", "learned"])
def composite(request):
    pos_type = request.param
    kw = dict(SMALL, pos_type=pos_type)
    jmod = JaxTransformerLM(**kw)
    params = jmod.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    tmod = TransformerLM(**kw)
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    smp_torch.init({}, device="cpu")
    model = smp_torch.DistributedModel(tmod, device="cpu")
    eos = _generate(model, EOS_PROMPT, 8)[2]  # the EOS stream stops by its third token
    port = ServingEngine(model, device="cpu", **TIGHT)
    released = []

    def watch(engine):
        if "eos" in engine.finished and "long" not in engine.finished:
            # The EOS stream's blocks are back in the pool the moment it
            # finished, while the long stream still decodes.
            released.append(set(engine.alloc._owned) == {"long"}
                            and engine.alloc.used_blocks == len(engine.alloc._owned["long"]))

    after_greedy = _run_composite(port, ServeRequest, eos, watch)
    refs = {rid: _generate(model, p, m) for rid, p, m in GREEDY}
    refs["long"] = _generate(model, LONG_PROMPT, 12)
    refs["eos"] = _truncate_at_eos(_generate(model, EOS_PROMPT, 8, eos_token_id=eos), eos)
    for rid, p, m, skw in STOCH:
        skw = dict(skw)
        refs[rid] = _generate(model, p, m, rng=key(skw.pop("seed")), **skw)
    smp_torch.reset()

    smp_jax.init({})
    ref_engine = JaxServingEngine(jmod, params=params, **TIGHT)
    _run_composite(ref_engine, JaxServeRequest, eos)
    jax_cache = jax.tree_util.tree_map(np.asarray, ref_engine._cache)
    smp_jax.reset()
    return dict(port=port, after_greedy=after_greedy, released=released, refs=refs, eos=eos,
                jax_results=dict(ref_engine.results), jax_stats=dict(ref_engine.stats),
                jax_mirror=ref_engine.mirror_log, jax_cache=jax_cache)


def test_tokens_match_jax_engine(composite):
    port = composite["port"]
    assert set(port.results) == set(composite["jax_results"]) and len(port.results) == 11
    for rid, want in composite["jax_results"].items():
        assert port.results[rid] == [int(t) for t in want], rid


def test_streams_match_generate(composite):
    port = composite["port"]
    for rid, want in composite["refs"].items():
        assert port.results[rid] == want, rid
    # The EOS stream stopped at its first EOS, at the latest its third token.
    assert port.results["eos"][-1] == composite["eos"] and len(port.results["eos"]) <= 3


def test_stats_and_mirror_log_match_jax(composite):
    port = composite["port"]
    assert dict(port.stats) == composite["jax_stats"]
    assert port.mirror_log == composite["jax_mirror"]
    assert all(rec["done"] for rec in port.mirror_log.values())


def test_pools_match_jax(composite):
    want = composite["jax_cache"]
    got = kv_pools_to_jax(composite["port"].kv_pools())
    for name in ("pool_key", "pool_value"):
        w, g = want["layers"]["block"]["attn"][name], got["layers"]["block"]["attn"][name]
        assert g.shape == w.shape == (2, 13, 4, 4, 8) and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_pool_conversion_round_trips(composite):
    """JAX tree -> port pools -> JAX tree, bit for bit."""
    want = composite["jax_cache"]
    back = kv_pools_to_jax(kv_pools_from_jax(want))
    for name in ("pool_key", "pool_value"):
        np.testing.assert_array_equal(back["layers"]["block"]["attn"][name], want["layers"]["block"]["attn"][name])


def test_continuous_batching_composite(composite):
    port = composite["port"]
    programs, decode_steps = composite["after_greedy"]
    assert programs == 2 and len(port._programs) == 2  # prefill chunk + decode step
    assert port.stats["prefill_chunks"] >= 5
    # Continuous batching takes fewer decode steps over the greedy batch
    # than the static batch-max schedule needs slot-steps.
    static_steps = -(-len(GREEDY) // 3) * max(m for _, _, m in GREEDY)
    assert decode_steps < static_steps
    assert composite["released"] and all(composite["released"])
    assert port.alloc.used_blocks == 0 and port.alloc.check() == []
    assert port.kv_block_bytes == 2 * 2 * 4 * 4 * 8 * 4  # K and V, 2 layers, [4 tokens, 4 heads, 8] fp32


def _port_engine(**kw):
    smp_torch.init({}, device="cpu")
    tmod = init_gpt2_weights_(TransformerLM(**SMALL), torch.Generator().manual_seed(0), std=0.5)
    return smp_torch.DistributedModel(tmod, device="cpu"), dict(max_slots=2, block_tokens_override=4,
                                                                prefill_chunk=4, device="cpu", **kw)


def test_requires_paged_capable_module():
    smp_torch.init({}, device="cpu")
    head = smp_torch.nn.DistributedTransformerLMHead(
        num_layers=1, num_attention_heads=2, attention_head_size=8, hidden_size=16, intermediate_size=32,
        vocab_size=31, num_positions=16, causal_mask_size=16, attention_dropout_prob=0.0,
        hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
    )
    with pytest.raises(SMPValidationError, match="paged"):
        ServingEngine(head, params={}, device="cpu")
    with pytest.raises(SMPValidationError, match="requires params"):
        ServingEngine(TransformerLM(**SMALL), device="cpu")


def test_submit_validation_and_idempotency():
    model, kw = _port_engine()
    engine = ServingEngine(model, **kw)
    with pytest.raises(SMPValidationError, match="position limit"):
        engine.submit(ServeRequest("big", list(range(40)), 30))
    assert engine.submit(ServeRequest("a", [1, 2, 3], 2))
    # Same rid queued again: skipped (idempotent re-admission).
    assert not engine.submit(ServeRequest("a", [1, 2, 3], 2))
    # A fully-resumed request completes without generating.
    assert engine.submit(ServeRequest("done", [1, 2], 2, resume_tokens=(5, 6)))
    assert engine.results["done"] == [5, 6] and engine.mirror_log["done"]["done"]
    assert not engine.submit(ServeRequest("done", [1, 2], 2))
    engine.run()
    assert not engine.submit(ServeRequest("a", [1, 2, 3], 2))  # finished
    assert engine.stats["admitted"] == 1


def test_resumed_request_continues_its_stream():
    """A record carrying the first tokens of a stream, re-admitted through
    ``serve_request_from_record``, continues the key schedule: the resumed
    stream equals the uninterrupted one, greedy and sampled."""
    model, kw = _port_engine()
    reqs = [ServeRequest("g", _prompt(40, 9), 7),
            ServeRequest("s", _prompt(41, 6), 7, temperature=0.9, top_k=20, top_p=0.9, seed=5)]
    full = ServingEngine(model, **kw).run(reqs)
    for req in reqs:
        rec = serve_request_to_record(req)
        assert serve_request_from_record(rec) == req
        rec["tokens"] = full[req.request_id][:3]
        resumed = ServingEngine(model, **kw)
        out = resumed.run([serve_request_from_record(rec)])
        assert out[req.request_id] == full[req.request_id], req.request_id
        assert resumed.stats["admitted"] == 1


def test_drain_returns_stragglers():
    model, kw = _port_engine()
    engine = ServingEngine(model, **dict(kw, max_slots=1))
    reqs = [ServeRequest(f"r{i}", _prompt(50 + i, 5), 4) for i in range(3)]
    for req in reqs:
        engine.submit(req)
    engine.step()  # admits r0 only
    stragglers = engine.drain()
    assert [rec["rid"] for rec in stragglers] == ["r1", "r2"]
    assert set(engine.results) == {"r0"} and not engine.busy
    assert not engine.submit(ServeRequest("late", [1], 1))  # quiesced
    engine.resume_admission()
    engine.run([serve_request_from_record(rec) for rec in stragglers])
    direct = ServingEngine(model, **kw).run([ServeRequest(r.request_id, r.prompt, 4) for r in reqs])
    assert engine.results == direct
    assert {rid for rid, _ in engine.drain_dirty()} == {"r0", "r1", "r2"} and engine.drain_dirty() == []


def test_close_keeps_unfinished_records():
    model, kw = _port_engine()
    engine = ServingEngine(model, **kw)
    engine.submit(ServeRequest("q", [1, 2], 3))
    engine.drain_dirty()
    engine.close()
    assert [rid for rid, _ in engine.drain_dirty()] == ["q"]
    assert not engine.submit(ServeRequest("r", [1], 1))


def test_adopt_params_refusals_and_zero_cost_adoption():
    model, kw = _port_engine()
    engine = ServingEngine(model, **kw)
    prompt = _prompt(60, 6)
    before = engine.run([ServeRequest("x", prompt, 5)])["x"]
    other = init_gpt2_weights_(TransformerLM(**SMALL), torch.Generator().manual_seed(1), std=0.5)
    new = other.state_dict()
    engine.submit(ServeRequest("busy", prompt, 5))
    engine.step()
    with pytest.raises(SMPValidationError, match="in flight"):
        engine.adopt_params(new)
    engine.drain()
    engine.resume_admission()
    bad = dict(new, **{"wte.weight": new["wte.weight"][:, :16]})
    with pytest.raises(SMPValidationError, match="avals"):
        engine.adopt_params(bad)
    with pytest.raises(SMPValidationError, match="avals"):
        engine.adopt_params({k: v.double() for k, v in new.items()})
    ptrs = [t.data_ptr() for t in engine.decode_mod.state_dict().values()]
    programs = dict(engine._programs)
    engine.adopt_params(new)
    assert engine.weights_version == 1
    assert [t.data_ptr() for t in engine.decode_mod.state_dict().values()] == ptrs
    assert engine._programs == programs
    after = engine.run([ServeRequest("y", prompt, 5)])["y"]
    # The adoption copied into the engine's own tensors, not the model's.
    assert engine.run([ServeRequest("z", prompt, 5)])["z"] != ServingEngine(model, **kw).run(
        [ServeRequest("z", prompt, 5)])["z"]
    assert after == ServingEngine(other, params=new, **kw).run([ServeRequest("y", prompt, 5)])["y"]
    assert after != before
    engine.adopt_params(new, version=7)
    assert engine.weights_version == 7


@pytest.mark.parametrize("env,value", [
    ("SMP_TIMESERIES_INTERVAL", "1.0"), ("SMP_FLEET_INTERVAL", "0.5"), ("SMP_CHAOS", "kill@decode=2"),
    ("SMP_TELEMETRY_PATH", "telemetry.json"), ("SMP_EXEC_CACHE", "on"), ("SMP_HLO_AUDIT", "on"),
    ("SMP_AUTOSCALE", "on"), ("SMP_DECODE_WEIGHTS", "int4"), ("SMP_KV_QUANT", "fp4"),
    # A value the JAX package would warn about and ignore is refused too.
    ("SMP_TIMESERIES_INTERVAL", "5s"), ("SMP_FLEET_INTERVAL", "fast"), ("SMP_AUTOSCALE", "yes"),
])
def test_refused_env_vars(monkeypatch, env, value):
    """Each variable that arms a left-out subsystem is refused; a bad value of
    an int8 knob raises the JAX package's ``ValueError``
    (``quant.kv_quant_mode`` / ``decode_weights_mode``)."""
    model, kw = _port_engine()
    monkeypatch.setenv(env, value)
    if env in ("SMP_DECODE_WEIGHTS", "SMP_KV_QUANT"):
        with pytest.raises(ValueError, match=f"{env}={value!r}: expected 'int8'"):
            ServingEngine(model, **kw)
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(model, **kw)


def test_env_vars_off_are_accepted(monkeypatch):
    model, kw = _port_engine()
    monkeypatch.setenv("SMP_TIMESERIES_INTERVAL", "0")
    monkeypatch.setenv("SMP_EXEC_CACHE", "off")
    monkeypatch.setenv("SMP_DECODE_WEIGHTS", "none")
    ServingEngine(model, **kw)


@pytest.mark.parametrize("degree", ["tensor_parallel_degree", "pipeline_parallel_degree",
                                    "context_parallel_degree"])
def test_more_than_one_rank_refused(monkeypatch, degree):
    model, kw = _port_engine()
    cfg = {degree: 2, "ddp": True}
    if degree == "pipeline_parallel_degree":
        cfg["microbatches"] = 2
    monkeypatch.setattr(state, "cfg", ModelParallelConfig(cfg))
    with pytest.raises(NotImplementedError, match="one device"):
        ServingEngine(model, **kw)


@pytest.mark.parametrize("name", ["ReplicatedServingEngine", "RequestRouter", "ServingController",
                                  "AutoscalePolicy", "LocalReplicaHandle", "router", "controller"])
def test_multi_process_tier_refused(name):
    with pytest.raises(NotImplementedError, match="slice 3"):
        getattr(serving, name)
    with pytest.raises(AttributeError):
        getattr(serving, "NoSuchThing")


def test_engine_defaults_to_cuda(monkeypatch):
    """device=None means cuda; without CUDA that is an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    smp_torch.init({})
    tmod = TransformerLM(**SMALL)
    with pytest.raises(SMPRuntimeError, match="CUDA is not available"):
        ServingEngine(tmod, params=tmod.state_dict())
