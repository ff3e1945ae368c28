"""The port's serving time series (``utils/timeseries.py``) and the serving
engine's observability seams against the JAX package's.

- ``MetricsTimeSeries`` under a fake clock, on fresh registries fed the same
  seeded serving counters, gauges and latency samples: the same windows
  (deltas, rates, window percentiles), SLO verdicts and published gauges;
  ``parse_slo``, ``evaluate_slo`` and the interval parser agree.
- A small engine burst (the zoo LM, 32 wide, from converted weights; 6
  ragged requests on 3 slots, greedy and sampled) in both packages with
  ``SMP_TELEMETRY_PATH`` and ``SMP_TIMESERIES_INTERVAL`` set: the same
  tokens, equal ``record_serve_*`` counts (requests by event, tokens by
  kind, latency samples by kind, programs, the last occupancy), equal window
  deltas when both sample a window after every tick, and the same
  flight-recorder span edges per request. ``scripts/slo_report.py`` reads
  the port's JSONL and exits 0. A bucketed ``smp.generate`` counts the same
  ``smp_shape_bucket_total`` outcomes in both.
- The engine's snapshotter thread stops at ``close()``.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smdistributed_modelparallel_tpu as smp_jax
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.serving import ServeRequest as JaxServeRequest
from smdistributed_modelparallel_tpu.serving import ServingEngine as JaxServingEngine
from smdistributed_modelparallel_tpu.utils import flight_recorder as jax_fr
from smdistributed_modelparallel_tpu.utils import telemetry as jax_tel
from smdistributed_modelparallel_tpu.utils import timeseries as jax_ts
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.serving import ServeRequest, ServingEngine
from smdistributed_modelparallel_tpu_torch.utils import flight_recorder as port_fr
from smdistributed_modelparallel_tpu_torch.utils import telemetry as port_tel
from smdistributed_modelparallel_tpu_torch.utils import timeseries as port_ts
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError as PortValidationError
from smdistributed_modelparallel_tpu.utils.exceptions import SMPValidationError as JaxValidationError

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=97, max_len=64, d_model=32, n_layers=2, n_heads=4)
TIGHT = dict(max_slots=3, num_blocks=13, block_tokens_override=4, prefill_chunk=4)
SLO = "ttft_p99_ms=5000,itl_p99_ms=100,queue_depth=2"
BURST_SLO = "queue_depth=2"  # the burst's verdicts must not depend on host timing


def _prompt(seed, length):
    return list(map(int, np.random.default_rng(seed).integers(0, SMALL["vocab_size"], length)))


BURST = [("a", _prompt(1, 7), 5, {}), ("b", _prompt(2, 11), 4, {}), ("c", _prompt(3, 3), 6, {}),
         ("d", _prompt(4, 5), 3, dict(temperature=1.0, seed=3)), ("e", _prompt(5, 9), 5, dict(top_k=5, seed=1)),
         ("f", _prompt(6, 6), 4, dict(temperature=0.8, top_p=0.9, seed=7))]


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    smp_jax.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


# ----------------------------------------------------------------------
# MetricsTimeSeries under a fake clock
# ----------------------------------------------------------------------


def _feed(tel, reg, rng):
    for _ in range(int(rng.integers(0, 6))):
        kind = tel.SERVE_LATENCY_KINDS[rng.integers(len(tel.SERVE_LATENCY_KINDS))]
        reg.histogram("smp_serve_latency_seconds", buckets=tel.LATENCY_BUCKETS).labels(kind=kind).observe(
            float(rng.exponential(0.05)))
    for ev in ("admitted", "finished"):
        reg.counter("smp_serve_requests_total").labels(event=ev).inc(float(rng.integers(0, 3)))
    reg.counter("smp_serve_tokens_total").labels(kind="generated").inc(float(rng.integers(0, 40)))
    reg.counter("smp_serve_tokens_total").labels(kind="prompt").inc(float(rng.integers(0, 40)))
    reg.gauge("smp_serve_queue_depth").set(float(rng.integers(0, 5)))
    reg.gauge("smp_serve_slots").labels(state="active").set(float(rng.integers(0, 4)))


def _series_run(tel, ts, seed, tmp_path):
    rng = np.random.default_rng(seed)
    reg = tel.TelemetryRegistry()
    clk = FakeClock()
    path = tmp_path / f"{ts.__name__}.jsonl"
    series = ts.MetricsTimeSeries(registry=reg, interval=1.0, size=4, path=str(path), slo=SLO, chips=2,
                                  clock=clk, wall=clk)
    got = []
    for _ in range(8):
        _feed(tel, reg, rng)
        clk.t += float(rng.uniform(0.5, 1.5))
        got.append(series.maybe_sample())
    got.append(series.sample())
    metrics = reg.report()["metrics"]
    return got, series.snapshots(), metrics, path.read_text()


@pytest.mark.parametrize("seed", range(3))
def test_time_series_matches_jax(seed, tmp_path):
    want = _series_run(jax_tel, jax_ts, seed, tmp_path)
    got = _series_run(port_tel, port_ts, seed, tmp_path)
    assert got == want
    windows = [w for w in got[0] if w is not None]
    assert len(got[1]) == 4 and windows and all("slo" in w for w in windows)


@pytest.mark.parametrize("spec", [SLO, "tokens_per_s_min=10", "itl_mean_ms=3, queue_depth=1", "", "bogus=1",
                                  "ttft_p99_ms", "ttft_p99_ms=fast"])
def test_parse_and_evaluate_slo_match_jax(spec):
    try:
        want = jax_ts.parse_slo(spec)
    except JaxValidationError as e:
        with pytest.raises(PortValidationError) as got:
            port_ts.parse_slo(spec)
        assert str(got.value) == str(e)
        return
    assert port_ts.parse_slo(spec) == want
    window = {"ttft_p99_ms": 6000.0, "itl_mean_ms": 2.0, "queue_depth": 3, "tokens_per_s": 5.0}
    assert port_ts.evaluate_slo(want, window) == jax_ts.evaluate_slo(want, window)
    assert port_ts.SLO_KEYS == jax_ts.SLO_KEYS


@pytest.mark.parametrize("raw", ["", "0", "0.5", "-1", "5s"])
def test_interval_parse_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("SMP_TIMESERIES_INTERVAL", raw)
    assert port_ts.timeseries_interval() == jax_ts.timeseries_interval()
    assert (port_ts.MetricsTimeSeries.from_env() is None) == (jax_ts.MetricsTimeSeries.from_env() is None)


# ----------------------------------------------------------------------
# The engine burst in both packages
# ----------------------------------------------------------------------


def _serve_env(mp, out):
    out.mkdir()
    mp.setenv("SMP_TELEMETRY_PATH", str(out / "telemetry.json"))
    mp.setenv("SMP_TIMESERIES_PATH", str(out / "windows.jsonl"))
    # Windows are cut by hand after every tick (the interval never elapses).
    mp.setenv("SMP_TIMESERIES_INTERVAL", "3600")
    mp.setenv("SMP_SLO", BURST_SLO)


def _drive(engine, make, windows):
    for rid, prompt, n, kw in BURST:
        engine.submit(make(rid, prompt, n, **kw))
    while engine.busy:
        engine.step()
        windows.append(engine.timeseries.sample())
    engine.close()
    return dict(engine.results)


def _serve_ring(fr):
    return sorted((e["rid"], e["event"], e.get("slot"), e.get("pos")) for e in fr.snapshot() if e["kind"] == "serve")


@pytest.fixture(scope="module")
def bursts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jmod = JaxTransformerLM(**SMALL)
    params = jmod.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _serve_env(mp, root / "jax")
        smp_jax.reset()
        smp_jax.init({})
        windows = []
        engine = JaxServingEngine(jmod, params=params, **TIGHT)
        results = _drive(engine, lambda rid, p, n, **kw: JaxServeRequest(rid, p, n, **kw), windows)
        ring = _serve_ring(jax_fr.flight_recorder)
        dmodel = smp_jax.DistributedModel(jmod)
        dmodel.params = params
        mp.setenv("SMP_SHAPE_BUCKETS", "seq:8,16")
        for T, n in ((5, 3), (8, 8), (3, 20)):
            smp_jax.generate(dmodel, jnp.asarray([_prompt(T, T)], jnp.int32), n)
        mp.delenv("SMP_SHAPE_BUCKETS")
        buckets = jax_tel.telemetry.report()["metrics"]["smp_shape_bucket_total"]
        smp_jax.shutdown()
        out["jax"] = dict(results=results, windows=windows, ring=ring, buckets=buckets,
                          dump=json.loads((root / "jax" / "telemetry.json").read_text()))
        smp_jax.reset()

        _serve_env(mp, root / "port")
        smp_torch.reset()
        smp_torch.init({}, device="cpu")
        tmod = TransformerLM(**SMALL)
        tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        model = smp_torch.DistributedModel(tmod, device="cpu")
        windows = []
        engine = ServingEngine(model, device="cpu", **TIGHT)
        results = _drive(engine, ServeRequest, windows)
        ring = _serve_ring(port_fr.flight_recorder)
        mp.setenv("SMP_SHAPE_BUCKETS", "seq:8,16")
        for T, n in ((5, 3), (8, 8), (3, 20)):
            smp_torch.generate(model, torch.tensor([_prompt(T, T)]), n)
        mp.delenv("SMP_SHAPE_BUCKETS")
        buckets = port_tel.telemetry.report()["metrics"]["smp_shape_bucket_total"]
        smp_torch.shutdown()
        out["port"] = dict(results=results, windows=windows, ring=ring, buckets=buckets, dir=root / "port",
                           dump=json.loads((root / "port" / "telemetry.json").read_text()))
    return out


def _values(doc, name):
    fam = doc["metrics"].get(name, {"series": []})
    return {tuple(sorted(s["labels"].items())): s.get("value", s.get("count")) for s in fam["series"]}


def test_burst_tokens_match_jax(bursts):
    assert bursts["port"]["results"] == bursts["jax"]["results"]


@pytest.mark.parametrize("name", ["smp_serve_requests_total", "smp_serve_tokens_total", "smp_serve_latency_seconds",
                                  "smp_serve_programs", "smp_serve_slots", "smp_serve_kv_blocks",
                                  "smp_serve_queue_depth", "smp_timeseries_windows", "smp_slo_ok",
                                  "smp_slo_goodput_fraction", "smp_slo_violations_total"])
def test_serve_counts_match_jax(bursts, name):
    want = _values(bursts["jax"]["dump"], name)
    assert want and _values(bursts["port"]["dump"], name) == want


WINDOW_KEYS = ("seq", "queue_depth", "active_slots", "kv_used_blocks", "requests_admitted", "requests_finished",
               "requests_readmitted", "tokens_generated", "tokens_prompt", "lifetime_tokens_generated")


def test_window_deltas_match_jax(bursts):
    def cut(windows):
        return [{k: w[k] for k in WINDOW_KEYS} for w in windows]

    want, got = cut(bursts["jax"]["windows"]), cut(bursts["port"]["windows"])
    assert got == want
    served = sum(len(t) for t in bursts["port"]["results"].values())
    assert sum(w["tokens_generated"] for w in got) == served


def test_request_spans_match_jax(bursts):
    assert bursts["port"]["ring"] == bursts["jax"]["ring"]
    assert {ev for _, ev, _, _ in bursts["port"]["ring"]} >= {"queued", "admitted", "prefill_chunk", "first_token",
                                                             "finished"}


def test_bucket_outcomes_match_jax(bursts):
    assert bursts["port"]["buckets"] == bursts["jax"]["buckets"]


def test_slo_report_reads_the_port_windows(bursts):
    out = bursts["port"]["dir"]
    lines = [json.loads(x) for x in (out / "windows.jsonl").read_text().splitlines()]
    assert len(lines) == len(bursts["port"]["windows"]) and all(w["kind"] == "serve_window" for w in lines)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, str(ROOT / "scripts" / "slo_report.py"), str(out / "windows.jsonl")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "window" in run.stdout


def test_snapshotter_thread_stops_at_close(monkeypatch):
    monkeypatch.setenv("SMP_TIMESERIES_INTERVAL", "0.01")
    smp_torch.init({}, device="cpu")
    model = smp_torch.DistributedModel(TransformerLM(**SMALL), device="cpu")
    engine = ServingEngine(model, device="cpu", **TIGHT)
    thread = engine.timeseries._thread
    assert thread is not None and thread.is_alive() and thread.name == "smp-timeseries"
    engine.run([ServeRequest("x", _prompt(9, 5), 3)])
    engine.close()
    assert engine.timeseries._thread is None and not thread.is_alive()
    assert engine.timeseries.snapshots()
