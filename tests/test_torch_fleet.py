"""The port's fleet metrics plane (``utils/fleet.py``) against the JAX
package's, under the JAX tests' ``FakeClock`` (``tests/test_fleet.py``).

Each scenario feeds both packages' planes (``bus=None``, an injected
``alive_fn``, clock and wall clock) the same registry contents and peer
snapshots and ticks them alike: the windows, the ``fleet_report`` scrape
documents, the ``smp_fleet_*`` gauges, the ``fleet`` flight-recorder events
and the ``SMP_FLEET_PATH`` JSONL records are equal, for a single-process
plane, gauge skew stats, the straggler detector (ITL and its step-time
fallback), the KV-imbalance detector, stale-versus-dead feeds, aggregator
re-election and the SLO goodput feed. A single-process plane's percentiles
are bit-equal to ``scripts/telemetry_report.py``'s offline merge of the
rank's dump. The scrape server binds port 0 and answers every route;
``smp.init`` starts the plane from the environment, the serving engine ticks
it, ``smp.shutdown`` stops it (its final window written, no thread left).
"""

import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import smdistributed_modelparallel_tpu_torch as smp_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import telemetry_report  # noqa: E402

PKGS = {"jax": "smdistributed_modelparallel_tpu", "port": "smdistributed_modelparallel_tpu_torch"}
FLEET_VARS = ("SMP_FLEET_INTERVAL", "SMP_METRICS_PORT", "SMP_FLEET_PATH", "SMP_SLO", "SMP_FLEET_STRAGGLER_RATIO",
              "SMP_FLEET_KV_IMBALANCE_RATIO", "SMP_FLEET_STALE_WINDOWS")


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.utils.{name}")


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in FLEET_VARS:
        monkeypatch.delenv(var, raising=False)
    yield
    smp_torch.reset()
    assert not [t for t in threading.enumerate() if t.name.startswith("smp-fleet")]


def _serve_registry(pkg, ttft=(), itl=(), step=(), kv_used=None, queue_depth=None, finished=0, generated=0):
    tel = _mod(pkg, "telemetry")
    reg = tel.TelemetryRegistry()
    lat = reg.histogram("smp_serve_latency_seconds", buckets=tel.LATENCY_BUCKETS)
    for v in ttft:
        lat.labels(kind="ttft").observe(v)
    for v in itl:
        lat.labels(kind="itl").observe(v)
    st = reg.histogram("smp_step_time_seconds", buckets=tel.LATENCY_BUCKETS)
    for v in step:
        st.labels().observe(v)
    if kv_used is not None:
        reg.gauge("smp_serve_kv_blocks").labels(state="used").set(kv_used)
    if queue_depth is not None:
        reg.gauge("smp_serve_queue_depth").labels().set(queue_depth)
    if finished:
        reg.counter("smp_serve_requests_total").labels(event="finished").inc(finished)
    if generated:
        reg.counter("smp_serve_tokens_total").labels(kind="generated").inc(generated)
    return reg


def _snap(reg, rank, seq=1, t_wall=0.0):
    rep = reg.report()
    return {"v": 1, "rank": rank, "seq": seq, "t_wall": t_wall, "phase": rep["meta"]["phase"],
            "metrics": {n: {"kind": f["kind"], "series": f["series"]} for n, f in rep["metrics"].items()}}


def _plane(pkg, world, rank, registry, clock, alive=None, **kw):
    return _mod(pkg, "fleet").FleetMetricsPlane(
        registry=registry, bus=None, rank=rank, world=world, interval=kw.pop("interval", 1.0),
        path=kw.pop("path", ""), port=kw.pop("port", None),
        alive_fn=alive if alive is not None else (lambda p: True), clock=clock, wall=clock,
        slo=kw.pop("slo", None), **kw)


def _fleet_gauges(reg):
    return {(n, tuple(sorted(s["labels"].items()))): s["value"]
            for n, f in reg.report()["metrics"].items() if n.startswith("smp_fleet")
            for s in f["series"]}


def _fleet_events(pkg):
    return [(e.get("event"), e.get("rank"), e.get("detail")) for e in _mod(pkg, "flight_recorder").flight_recorder
            .snapshot() if e.get("kind") == "fleet"]


def _scenario(pkg, name, tmp):
    """Plays scenario ``name`` in ``pkg``; returns everything observable."""
    _mod(pkg, "flight_recorder").flight_recorder.clear()
    clk = FakeClock()
    out = []
    path = str(tmp / f"{pkg}_{name}.jsonl")
    if name == "single_process":
        reg = _serve_registry(pkg, ttft=[0.01, 0.02], finished=2, generated=10)
        p = _plane(pkg, 1, 0, reg, clk, path=path)
        out += [p.tick(), p.tick()]
        clk.t += 1.5
        reg.counter("smp_serve_requests_total").labels(event="finished").inc(3)
        reg.counter("smp_serve_tokens_total").labels(kind="generated").inc(30)
        reg.histogram("smp_serve_latency_seconds").labels(kind="ttft").observe(0.4)
        out.append(p.tick())
        for _ in range(5):
            clk.t += 0.1
            out.append(p.tick())
    elif name == "skew":
        reg = _serve_registry(pkg, ttft=[0.01], kv_used=10, queue_depth=2)
        p = _plane(pkg, 2, 0, reg, clk)
        p._ingest(1, _snap(_serve_registry(pkg, ttft=[0.01], kv_used=30, queue_depth=6), 1), clk.t)
        out.append(p.tick())
    elif name in ("straggler_itl", "straggler_step"):
        slow = dict(itl=[0.25] * 20) if name == "straggler_itl" else dict(step=[0.05] * 10)
        fast = dict(itl=[0.01] * 20) if name == "straggler_itl" else dict(step=[0.05] * 10)
        reg = _serve_registry(pkg, **fast)
        p = _plane(pkg, 2, 0, reg, clk, straggler_ratio_=2.0)
        p._ingest(1, _snap(_serve_registry(pkg, **slow), 1), clk.t)
        out.append(p.tick())
        out.append(sorted(p.straggling))
    elif name == "kv_imbalance":
        reg = _serve_registry(pkg, ttft=[0.01], kv_used=100)
        p = _plane(pkg, 2, 0, reg, clk, kv_imbalance_ratio_=1.5)
        p._ingest(1, _snap(_serve_registry(pkg, ttft=[0.01], kv_used=2), 1), clk.t)
        out.append(p.tick())
    elif name == "stale_vs_dead":
        alive = {1: True, 2: False}
        reg = _serve_registry(pkg, ttft=[0.01], finished=1)
        reg1 = _serve_registry(pkg, ttft=[0.02], finished=1)
        p = _plane(pkg, 3, 0, reg, clk, alive=lambda r: alive.get(r, True), stale_windows_=3)
        p._ingest(1, _snap(reg1, 1), clk.t)
        p._ingest(2, _snap(_serve_registry(pkg, ttft=[0.03]), 1), clk.t)
        out.append(p.tick())
        for _ in range(4):
            clk.t += 1.0
            out.append(p.tick())
        p._ingest(1, _snap(reg1, 2), clk.t)
        clk.t += 1.0
        out.append(p.tick())
    elif name == "reelection":
        alive = {0: True, 2: True}
        reg = _serve_registry(pkg, ttft=[0.01])
        p = _plane(pkg, 3, 1, reg, clk, alive=lambda r: alive.get(r, True))
        out += [p.tick(), p.aggregator, p.is_aggregator]
        alive[0] = False
        clk.t += 1.0
        out += [p.tick(), p.aggregator, p.is_aggregator]
    elif name == "slo_feed":
        reg = _serve_registry(pkg, ttft=[0.9], finished=1)
        p = _plane(pkg, 1, 0, reg, clk, path=path, slo="ttft_p99_ms=100")
        out.append(p.tick())
        clk.t += 1.0
        out.append(p.tick())
    out.append(p.fleet_report())
    out.append(p.windows())
    out.append(_fleet_gauges(p.registry))
    out.append(_fleet_events(pkg))
    out.append([json.loads(ln) for ln in open(path)] if os.path.exists(path) else None)
    p.stop()
    return out


@pytest.mark.parametrize("name", ["single_process", "skew", "straggler_itl", "straggler_step", "kv_imbalance",
                                  "stale_vs_dead", "reelection", "slo_feed"])
def test_plane_matches_jax(tmp_path, name):
    want = _scenario("jax", name, tmp_path)
    got = _scenario("port", name, tmp_path)
    assert got == want
    assert any(w for w in got if isinstance(w, dict) and w.get("kind") == "fleet_window")


def test_single_process_percentiles_bit_equal_offline_merge(tmp_path):
    reg = _serve_registry("port", ttft=[0.01, 0.03, 0.2, 1.7], itl=[0.004, 0.009, 0.02], step=[0.05, 0.3])
    clk = FakeClock()
    p = _plane("port", 1, 0, reg, clk)
    p.tick()
    doc = p.fleet_report()
    p.stop()
    with open(tmp_path / "telemetry.json", "w") as fh:
        json.dump(reg.report(), fh)
    merged = telemetry_report.aggregate(telemetry_report.load_rank_dumps(str(tmp_path)))
    for kind in ("ttft", "itl"):
        s = [x for x in merged["metrics"]["smp_serve_latency_seconds"]["series"] if x["labels"] == {"kind": kind}][0]
        for stat, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            assert doc["percentiles"][kind][f"{stat}_s"] == telemetry_report._quantile_from_counts(
                s["buckets"], s["counts"], q)
    st = merged["metrics"]["smp_step_time_seconds"]["series"][0]
    assert doc["percentiles"]["step_time"]["p99_s"] == telemetry_report._quantile_from_counts(
        st["buckets"], st["counts"], 0.99)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_scrape_server_routes_on_an_ephemeral_port():
    reg = _serve_registry("port", ttft=[0.01, 0.05], finished=2)
    p = _plane("port", 1, 0, reg, FakeClock(), port=0)
    p.start()
    try:
        assert p.bound_port
        st, ct, body = _get(p.bound_port, "/metrics")
        assert st == 200 and ct.startswith("text/plain") and b"smp_serve_requests_total" in body
        st, ct, body = _get(p.bound_port, "/metrics.json")
        assert st == 200 and ct == "application/json" and "metrics" in json.loads(body)
        p.tick()
        st, _, body = _get(p.bound_port, "/fleet")
        assert st == 200 and json.loads(body)["kind"] == "fleet_report"
        st, _, body = _get(p.bound_port, "/fleet/metrics")
        assert st == 200 and b"smp_serve_latency_seconds" in body
        st, _, body = _get(p.bound_port, "/nope")
        assert st == 404
    finally:
        p.stop()
    assert p.bound_port is None


def test_smp_init_starts_the_plane_the_engine_ticks_it_and_shutdown_stops_it(monkeypatch, tmp_path):
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.serving import ServeRequest, ServingEngine
    from smdistributed_modelparallel_tpu_torch.utils.fleet import FleetMetricsPlane, fleet

    assert FleetMetricsPlane.from_env() is None
    smp_torch.init({}, device="cpu")
    assert fleet.plane is None  # unset: nothing constructed
    smp_torch.reset()
    path = tmp_path / "fleet.jsonl"
    monkeypatch.setenv("SMP_FLEET_INTERVAL", "0.05")
    monkeypatch.setenv("SMP_METRICS_PORT", "0")
    monkeypatch.setenv("SMP_FLEET_PATH", str(path))
    smp_torch.init({}, device="cpu")
    plane = fleet.plane
    assert plane is not None and plane.bound_port and plane.world == 1 and plane.is_aggregator
    lm = smp_torch.DistributedModel(TransformerLM(vocab_size=17, max_len=16, d_model=8, n_layers=1, n_heads=2))
    engine = ServingEngine(lm, max_slots=2, num_blocks=9, block_tokens_override=4, prefill_chunk=4, device="cpu")
    ticks = []
    monkeypatch.setattr(fleet, "tick", lambda: ticks.append(plane.tick()))
    out = engine.run([ServeRequest("a", [1, 2, 3], 4), ServeRequest("b", [4, 5], 3)])
    assert len(out["a"]) == 4 and len(out["b"]) == 3 and ticks
    time.sleep(0.06)  # past the interval: the next tick ingests the finished burst
    plane.tick()
    st, _, body = _get(plane.bound_port, "/fleet")
    assert st == 200 and json.loads(body)["percentiles"]["ttft"]["count"] == 2
    smp_torch.shutdown()
    assert fleet.plane is None and plane.bound_port is None
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines and lines[0]["resync"] is True and [ln["seq"] for ln in lines] == list(range(1, len(lines) + 1))
    assert sum(ln.get("ttft_count", 0) for ln in lines if not ln["resync"]) + max(
        ln.get("ttft_count", 0) for ln in lines if ln["resync"]) == 2
