"""The port's telemetry registry (``utils/telemetry.py``) against the JAX
package's.

The same sequence of counter, gauge and histogram calls, labels included,
drawn from a numpy seed, goes to a fresh ``TelemetryRegistry`` of each
package: ``report()["metrics"]`` and ``render_prometheus()`` are equal (the
meta block carries a pid and clock times, so it is compared by keys). The
same holds for ``merge_metric_reports`` over per-rank reports, for the
log-histogram percentiles (``quantile_from_counts``), for the serving and
step recorders on the process registries, for the watchdog's wait and
dump, and for the rank-qualified dump path. Last, the README's metric
registry gate (``tests/test_metric_registry.py``'s AST scanner) runs over
the port's package: every ``smp_*`` name the port emits is a row of the
table. And a two-stack model (the encoder-decoder under ``fused_qkv``)
counts its fused-kernel dispatches as the JAX package does over two
training steps and two generate calls.
"""

import json
import pathlib

import numpy as np
import pytest

import torch

import test_metric_registry
from smdistributed_modelparallel_tpu.utils import telemetry as jax_tel
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.utils import telemetry as port_tel
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPWatchdogTimeout

PORT_PKG = pathlib.Path(__file__).resolve().parent.parent / "smdistributed_modelparallel_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_singletons():
    for mod in (jax_tel, port_tel):
        mod.telemetry.reset()
    yield
    for mod in (jax_tel, port_tel):
        mod.telemetry.reset()
        mod.telemetry.process_index, mod.telemetry.process_count = None, 1


def _ops(seed, n=60):
    """A seeded sequence of registry calls: (kind, name, labels, method, value)."""
    rng = np.random.default_rng(seed)
    names = {"counter": ["smp_a_total", "smp_b_total"], "gauge": ["smp_g", "smp_h"],
             "histogram": ["smp_lat_seconds"]}
    label_sets = [{}, {"kind": "x"}, {"kind": "y", "op": "z"}]
    out = []
    for _ in range(n):
        kind = ["counter", "gauge", "histogram"][rng.integers(3)]
        name = names[kind][rng.integers(len(names[kind]))]
        labels = label_sets[rng.integers(len(label_sets))]
        if kind == "counter":
            out.append((kind, name, labels, "inc", float(rng.integers(1, 5))))
        elif kind == "gauge":
            method = ["set", "inc", "dec"][rng.integers(3)]
            out.append((kind, name, labels, method, float(np.round(rng.normal() * 100, 3))))
        else:
            out.append((kind, name, labels, "observe", float(rng.exponential(0.05))))
    return out


def _apply(reg, ops, buckets):
    for kind, name, labels, method, value in ops:
        if kind == "histogram":
            fam = reg.histogram(name, "a histogram", buckets=buckets)
        else:
            fam = getattr(reg, kind)(name, f"a {kind}")
        getattr(fam.labels(**labels), method)(value)
    return reg


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("buckets", ["default", "latency"])
def test_registry_report_and_prometheus_match_jax(seed, buckets):
    ops = _ops(seed)
    b = None if buckets == "default" else jax_tel.LATENCY_BUCKETS
    want = _apply(jax_tel.TelemetryRegistry(), ops, b)
    got = _apply(port_tel.TelemetryRegistry(), ops, b)
    assert got.report()["metrics"] == want.report()["metrics"]
    assert got.render_prometheus() == want.render_prometheus()
    assert got.report()["meta"].keys() == want.report()["meta"].keys()


def test_bucket_tuples_and_kinds_match_jax():
    assert port_tel.LATENCY_BUCKETS == jax_tel.LATENCY_BUCKETS
    assert port_tel.DEFAULT_BUCKETS == jax_tel.DEFAULT_BUCKETS
    assert port_tel.SERVE_LATENCY_KINDS == jax_tel.SERVE_LATENCY_KINDS
    for lo, hi, g in ((5e-4, 240.0, 1.3), (1e-3, 10.0, 2.0)):
        assert port_tel._geometric_buckets(lo, hi, g) == jax_tel._geometric_buckets(lo, hi, g)


@pytest.mark.parametrize("seed", range(3))
def test_quantiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    buckets = list(jax_tel.LATENCY_BUCKETS)
    counts = [int(c) for c in rng.integers(0, 7, len(buckets) + 1)]
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert port_tel.quantile_from_counts(buckets, counts, q) == jax_tel.quantile_from_counts(buckets, counts, q)
    assert port_tel.quantile_from_counts(buckets, [0] * len(counts), 0.5) is None


@pytest.mark.parametrize("as_dict", [True, False])
def test_merge_metric_reports_matches_jax(as_dict):
    reports = []
    for rank in range(3):
        reg = _apply(jax_tel.TelemetryRegistry(), _ops(10 + rank), jax_tel.LATENCY_BUCKETS)
        rep = reg.report()
        rep["meta"]["rank"] = rank
        reports.append(rep)
    arg = {i: r for i, r in enumerate(reports)} if as_dict else reports
    want = jax_tel.merge_metric_reports(arg)
    got = port_tel.merge_metric_reports(arg)
    assert got == want
    assert port_tel.render_prometheus_report(got) == jax_tel.render_prometheus_report(want)


def _serve_and_step_calls(mod, seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        mod.record_serve_latency(["ttft", "itl", "queue_wait", "prefill", "decode_step"][rng.integers(5)],
                                 float(rng.exponential(0.02)))
        mod.record_step_time(float(rng.exponential(0.1)))
    mod.record_serve_request("admitted", 3)
    mod.record_serve_request("finished")
    mod.record_serve_tokens("generated", 17)
    mod.record_serve_tokens("prompt", 0)  # zero: nothing recorded
    mod.record_serve_occupancy(2, 3, 8, 10, 100, 4, 129, block_bytes=4096)
    mod.record_serve_programs(2)
    mod.record_quant_state(["qkv.x", "qkv.w"], [1.5, 0.25], [0.01, 0.002])
    mod.record_quant_dispatch("kv_cache", "int8")
    mod.record_fused_kernel_dispatch("qkv", "pallas")
    mod.record_weight_update(0.5, 3, fresh=0)
    mod.record_loss_scale("overflow", 1024.0)
    mod.record_elastic_resume(2, 1, detail="layout")
    return mod.telemetry.report()["metrics"]


@pytest.mark.parametrize("seed", range(2))
def test_recorders_match_jax(seed):
    """The serving, step, quant, fused-dispatch, loss-scale and
    elastic-resume recorders on the process registries: the same families,
    series and values."""
    want = _serve_and_step_calls(jax_tel, seed)
    got = _serve_and_step_calls(port_tel, seed)
    assert got == want
    summary = port_tel.serve_latency_summary("itl")
    assert summary == jax_tel.serve_latency_summary("itl")


def test_phase_history_and_listener():
    seen = []
    reg = port_tel.TelemetryRegistry()
    reg._phase_listener = seen.append
    for i in range(70):
        reg.set_phase(f"step_{i}")
    rep = reg.report()
    assert reg.phase == "step_69" and rep["meta"]["phase"] == "step_69"
    assert len(rep["meta"]["phase_history"]) == 64 and seen[-1] == "step_69" and len(seen) == 70


def test_kind_conflicts_and_counter_rules_match_jax():
    for mod in (jax_tel, port_tel):
        reg = mod.TelemetryRegistry()
        reg.counter("smp_x_total").inc()
        with pytest.raises(ValueError, match="already registered as counter"):
            reg.gauge("smp_x_total")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("smp_x_total").inc(-1)
        with pytest.raises(ValueError, match="gauge-only"):
            reg.counter("smp_x_total").set(1)


@pytest.mark.parametrize("world", [1, 4])
def test_dump_path_is_rank_qualified(tmp_path, monkeypatch, world):
    reg = port_tel.TelemetryRegistry()
    reg.process_index, reg.process_count = 2, world
    reg.counter("smp_step_total").inc(3)
    path = tmp_path / "tel.json"
    assert reg.dump() is None  # neither an argument nor SMP_TELEMETRY_PATH
    monkeypatch.setenv("SMP_TELEMETRY_PATH", str(path))
    written = reg.dump()
    want = f"{path}.rank2" if world > 1 else str(path)
    assert written == want
    doc = json.loads(pathlib.Path(written).read_text())
    assert doc["meta"]["rank"] == 2 and doc["meta"]["world"] == world
    assert doc["metrics"]["smp_step_total"]["series"][0]["value"] == 3


def test_watchdog_wait_raises_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("SMP_WATCHDOG_PATH", str(tmp_path / "wd.json"))
    monkeypatch.setenv("SMP_WATCHDOG_TIMEOUT", "0.05")
    wd = port_tel.watchdog
    assert wd.enabled and wd.timeout() == pytest.approx(0.05)
    port_tel.telemetry.set_phase("step_7")
    with pytest.raises(SMPWatchdogTimeout, match="step_7/recv stalled"):
        wd.wait(lambda: False, "step_7/recv", interval=0.01)
    doc = json.loads((tmp_path / "wd.json").read_text())
    assert doc["phase"] == "step_7/recv" and doc["telemetry"]["meta"]["phase"] == "step_7"
    assert doc["flight_recorder"]["events"][-1]["kind"] == "watchdog"
    assert wd.wait(lambda: 5, "ok") == 5


@pytest.mark.parametrize("raw, want", [("", None), ("0", None), ("abc", None), ("2.5", 2.5)])
def test_watchdog_timeout_parse_matches_jax(monkeypatch, raw, want):
    monkeypatch.setenv("SMP_WATCHDOG_TIMEOUT", raw)
    assert port_tel.watchdog.timeout() == jax_tel.watchdog.timeout() == want


def test_watchdog_guard_fires_from_timer(tmp_path, monkeypatch):
    import time

    monkeypatch.setenv("SMP_WATCHDOG_PATH", str(tmp_path / "wd.json"))
    monkeypatch.setenv("SMP_WATCHDOG_TIMEOUT", "0.02")
    with port_tel.watchdog.guard("init/topology") as g:
        time.sleep(0.2)
    assert g.fired and json.loads((tmp_path / "wd.json").read_text())["phase"] == "init/topology"
    monkeypatch.delenv("SMP_WATCHDOG_TIMEOUT")
    with port_tel.watchdog.guard("x") as g:
        pass
    assert g._timer is None and not g.fired


def test_port_metric_names_are_in_the_readme_registry(monkeypatch):
    """``tests/test_metric_registry.py``'s scanner over the port: every
    ``smp_*`` name it registers is a row of README's table (no name of its
    own), and it emits the step, serving, goodput and roofline families."""
    monkeypatch.setattr(test_metric_registry, "_PKG", PORT_PKG)
    emitted = test_metric_registry._emitted_names()
    missing = sorted(emitted - test_metric_registry._documented_names())
    assert not missing, missing
    assert {"smp_step_total", "smp_mfu", "smp_goodput_fraction", "smp_serve_requests_total",
            "smp_shape_bucket_total", "smp_device_peak_hbm_bytes", "smp_slo_violations_total"} <= emitted


# ----------------------------------------------------------------------
# The fused-kernel dispatch counter of a two-stack model
# ----------------------------------------------------------------------

ENCDEC = dict(vocab_size=64, d_model=32, enc_layers=2, dec_layers=2, n_heads=4, d_ff=64, max_len=16,
              deterministic=True)


def _encdec_counts(smp, ed, train_loss, generate_ids):
    """The fused-dispatch counter of ``smp``'s encoder-decoder (fused QKV)
    after each of 2 training steps and 2 generate calls of one program."""
    enc, dec, as_ids = generate_ids
    model = smp.DistributedModel(ed.EncoderDecoderLM(**ENCDEC), **({"device": "cpu"} if smp is smp_torch else {}))
    opt = smp.DistributedOptimizer(_sgd(smp, model), model)

    @smp.step
    def train(model, enc, dec):
        loss = train_loss(model(enc, dec[:, :-1]), dec)
        model.backward(loss)
        return loss

    def count():
        fam = smp.telemetry.report()["metrics"]["smp_fused_kernel_dispatch_total"]
        return {(s["labels"]["kernel"], s["labels"]["path"]): s["value"] for s in fam["series"]}

    got = []
    for _ in range(2):
        train(model, as_ids(enc), as_ids(dec))
        opt.step()
        got.append(count())
    for _ in range(2):
        smp.generate(model, as_ids(enc[:1]), 4)
        got.append(count())
    return got


def _sgd(smp, model):
    if smp is smp_torch:
        return torch.optim.SGD(model.parameters(), lr=0.1)
    import optax

    return optax.sgd(0.1)


def test_two_stack_dispatch_counts_match_jax(monkeypatch):
    """An encoder-decoder ticks each stack: the JAX package counts the fused
    QKV decision once a traced scan, so per stack and per program (the
    step's first compile with its lazy init, each new generate program,
    whose encoder runs once and decoder twice)."""
    import jax
    import jax.numpy as jnp

    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.models import encoder_decoder as jax_ed
    from smdistributed_modelparallel_tpu.ops import pallas_qkv
    from smdistributed_modelparallel_tpu_torch.models import encoder_decoder as port_ed
    from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

    rng = np.random.default_rng(0)
    ids = (rng.integers(0, 64, (4, 12)).astype(np.int32), rng.integers(0, 64, (4, 9)).astype(np.int32))
    monkeypatch.setattr(pallas_qkv, "FORCE_INTERPRET", True)
    monkeypatch.setattr(mb, "_is_cuda", lambda t: True)

    def jax_loss(logits, dec):
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(logits, dec[:, 1:, None], axis=-1)[..., 0])

    def port_loss(logits, dec):
        return torch.nn.functional.cross_entropy(logits.reshape(-1, 64), dec[:, 1:].reshape(-1))

    try:
        jax_smp.init({"microbatches": 2, "fused_qkv": True})
        want = _encdec_counts(jax_smp, jax_ed, jax_loss, (*ids, jnp.asarray))
    finally:
        jax_smp.reset()
    try:
        smp_torch.init({"microbatches": 2, "fused_qkv": True}, device="cpu")
        got = _encdec_counts(smp_torch, port_ed, port_loss, (*ids, lambda a: torch.from_numpy(a).long()))
    finally:
        smp_torch.reset()
    assert got == want
    assert [c[("qkv", "pallas")] for c in got] == [12, 12, 18, 18]
