"""The port's serving control plane against the JAX package's, in one process.

Each scenario runs twice, once over each package's ``smp.serving`` names
(``AutoscalePolicy``, ``RequestRouter``, ``ServingController``,
``LocalReplicaHandle``), on the same inputs and a fake clock, and the two
runs must give the same decisions, routing, feed records (the
``SMP_CONTROLLER_PATH`` JSONL, time fields aside) and gauges:
  - the policy: hysteresis both ways, the comfort rule (queue empty and every
    upper-bound metric under half its limit), the cooldown latch, the clamps,
    flapping windows, validation;
  - the router: least-loaded dispatch with the name tiebreak, dead handles,
    the split table, sticky version splits by request id over 40 requests,
    the fallback to any live replica;
  - ``from_env``: every ``SMP_AUTOSCALE*``/``SMP_CANARY*``/``SMP_CONTROLLER_PATH``
    knob, None when disarmed, the fallback on a bad number;
  - scale events over fake handles: up (phases, the open event closed by
    the first result, the feed, the gauges), up without a standby, down
    through the drain protocol (the straggler re-dispatched, results kept,
    the min clamp), and ``chaos.on_scale_event`` after each finished event;
  - a burst on real engines (``LocalReplicaHandle``, the zoo TransformerLM
    from the same weights, fp32): 16 requests on one oversubscribed replica
    scale it 1 -> 2 on a queue-depth breach and drain back 2 -> 1. The
    windows are a function of the tick (so both packages see the same ones),
    the decisions and feed records agree, and every stream equals a
    never-scaled run's and the other package's tokens.
The canary (promote on unchanged weights, roll back on corrupted ones) is
held on the port's engines alone, against its own reference tokens: the
JAX package's composite of it fails on the reference (ROADMAP Queue 3).
"""

import importlib
import json
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu import serving as jax_serving
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.utils.telemetry import telemetry as jax_telemetry
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch import serving as port_serving
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry as port_telemetry

PACKAGES = {
    "jax": types.SimpleNamespace(serving=jax_serving, telemetry=jax_telemetry,
                                 chaos=importlib.import_module("smdistributed_modelparallel_tpu.resilience.chaos")),
    "port": types.SimpleNamespace(serving=port_serving, telemetry=port_telemetry,
                                  chaos=importlib.import_module("smdistributed_modelparallel_tpu_torch.resilience.chaos")),
}
TIME_FIELDS = ("t_wall", "seconds")
GAUGES = ("smp_controller_replicas", "smp_autoscale_events_total", "smp_controller_routed_total",
          "smp_controller_drain_stragglers_total", "smp_canary_promotions_total", "smp_canary_rollback_total",
          "smp_canary_active", "smp_controller_weights_version", "smp_weight_updates_total")


@pytest.fixture(autouse=True)
def _fresh():
    for ns in PACKAGES.values():
        ns.telemetry.reset()
        ns.serving.controller.reset_all()
    yield
    for ns in PACKAGES.values():
        ns.telemetry.reset()
        ns.serving.controller.reset_all()
    smp.reset()
    jax_smp.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class FakeHandle:
    """Router-surface stand-in: load = static base + accepted work."""

    def __init__(self, name, version=0, load=0):
        self.name, self.version, self.live = str(name), int(version), True
        self._load = int(load)
        self.submitted, self._results, self.stragglers = [], {}, []
        self.drained = False

    def load(self):
        return self._load + len(self.submitted)

    def submit(self, req):
        self.submitted.append(req)
        return True

    def step(self):
        return False

    def poll(self):
        pass

    def drain(self, timeout_s=120.0):
        self.drained = True
        return list(self.stragglers)

    def results(self):
        return dict(self._results)

    @property
    def busy(self):
        return False


def _record(rid, prompt=(1, 2), max_new=3, tokens=()):
    return {"rid": rid, "prompt": list(prompt), "max_new_tokens": max_new, "temperature": 0.0, "top_k": None,
            "top_p": None, "eos_token_id": None, "seed": 0, "deadline_s": None, "tokens": list(tokens),
            "done": False, "trace_id": None}


def _gauges(ns):
    """The control plane's series: {(name, labels): value}."""
    out = {}
    for name, fam in ns.telemetry.report()["metrics"].items():
        if name in GAUGES:
            for s in fam["series"]:
                out[(name, tuple(sorted(s["labels"].items())))] = s.get("value")
    return out


def _timeless(rec):
    """A feed record or scale event with its times taken out (the phase
    names stay)."""
    rec = {k: v for k, v in rec.items() if k not in TIME_FIELDS}
    if "phases" in rec:
        rec["phases"] = sorted(rec["phases"])
    return rec


def _feed(path):
    try:
        with open(path) as f:
            return [_timeless(json.loads(line)) for line in f]
    except FileNotFoundError:
        return []


def _both(scenario, *args):
    """Run ``scenario(ns, *args)`` over each package; return both results."""
    return {name: scenario(ns, *args) for name, ns in PACKAGES.items()}


def _same(scenario, *args):
    got = _both(scenario, *args)
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

POLICY_TABLES = {
    "hysteresis_up": (dict(slo={"queue_depth": 2.0}, hysteresis=2, cooldown_s=0.0),
                      [({"queue_depth": 5}, 1, 1.0), ({"queue_depth": 5}, 1, 1.0), ({"queue_depth": 5}, 2, 0.0)]),
    "down_needs_headroom": (dict(slo={"ttft_p99_ms": 100.0}, hysteresis=2, cooldown_s=0.0),
                            [({"ttft_p99_ms": 60.0, "queue_depth": 0}, 2, 0.0)] * 4
                            + [({"ttft_p99_ms": 40.0, "queue_depth": 0}, 2, 0.0),
                               ({"ttft_p99_ms": 40.0, "queue_depth": 1}, 2, 0.0),
                               ({"ttft_p99_ms": 40.0, "queue_depth": 0}, 2, 0.0),
                               ({"ttft_p99_ms": 40.0, "queue_depth": 0}, 2, 0.0)]),
    "cooldown": (dict(slo={"queue_depth": 2.0}, hysteresis=1, cooldown_s=10.0),
                 [({"queue_depth": 5}, 1, 5.0), ({"queue_depth": 5}, 2, 5.1), ({"queue_depth": 5}, 2, 0.0)]),
    "clamps": (dict(slo={"queue_depth": 2.0}, hysteresis=1, cooldown_s=0.0, min_replicas=1, max_replicas=2),
               [({"queue_depth": 9}, 2, 0.0), ({"queue_depth": 9}, 1, 0.0), ({"queue_depth": 0}, 1, 0.0),
                ({"queue_depth": 0}, 1, 0.0)]),
    "flapping": (dict(slo={"queue_depth": 2.0}, hysteresis=2, cooldown_s=0.0),
                 [({"queue_depth": 5}, 2, 0.0), ({"queue_depth": 0}, 2, 0.0)] * 6),
    "no_slo": (dict(slo=None, hysteresis=1, cooldown_s=0.0),
               [({"queue_depth": 0}, 2, 0.0), ({"queue_depth": 3}, 2, 0.0)]),
}


def _policy_run(ns, kw, table):
    clk = FakeClock()
    kw = dict(kw)
    p = ns.serving.AutoscalePolicy(kw.pop("slo"), clock=clk, **kw)
    out = []
    for window, live, advance in table:
        out.append((p.observe(window, live=live), p.last_verdict["ok"], p.streak_started,
                    p.fired_streak_started))
        clk.advance(advance)
    return out


@pytest.mark.parametrize("case", sorted(POLICY_TABLES))
def test_policy_decisions_match_jax(case):
    got = _same(_policy_run, *POLICY_TABLES[case])
    assert any(d is not None for d, *_ in got) or case in ("flapping", "no_slo")


@pytest.mark.parametrize("kw", [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2), dict(hysteresis=0)])
def test_policy_validation(kw):
    with pytest.raises(Exception) as want:
        jax_serving.AutoscalePolicy(**kw)
    with pytest.raises(SMPValidationError) as got:
        port_serving.AutoscalePolicy(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


def _router_run(ns):
    S = ns.serving
    out = {}
    r = S.RequestRouter()
    r.attach(FakeHandle("a", load=3))
    r.attach(FakeHandle("b", load=1))
    out["least_loaded"] = [r.dispatch(S.ServeRequest(f"r{i}", [1, 2], 4)) for i in range(5)]
    out["routed"] = dict(r.routed)
    dead = S.RequestRouter()
    dead.attach(FakeHandle("a")).live = False
    out["dead"] = (dead.dispatch(S.ServeRequest("x", [1], 2)), dead.live_handles())
    try:
        r.attach(FakeHandle("a"))
        out["duplicate"] = None
    except Exception as e:
        out["duplicate"] = (type(e).__name__, str(e))
    errors = []
    for split in ({0: 0.5, 1: 0.6}, {}):
        try:
            r.set_split(split)
        except Exception as e:
            errors.append((type(e).__name__, str(e)))
    out["split_errors"] = errors
    r.set_split({0: 0.75, 1: 0.25})
    out["split"] = r.split
    r.set_split(None)
    out["split_off"] = r.split
    sticky = S.RequestRouter()
    sticky.attach(FakeHandle("v0", version=0))
    sticky.attach(FakeHandle("v1", version=1))
    sticky.set_split({0: 0.75, 1: 0.25})
    out["sticky"] = {f"r{i}": sticky.dispatch(S.ServeRequest(f"r{i}", [1], 2)) for i in range(40)}
    fallback = S.RequestRouter()
    fallback.attach(FakeHandle("v0", version=0))
    fallback.set_split({0: 0.0, 1: 1.0})
    out["fallback"] = fallback.dispatch(S.ServeRequest("x", [1], 2))
    out["rid_fractions"] = [ns.serving.router._rid_fraction(f"req-{i}") for i in range(8)]
    out["gauges"] = _gauges(ns)
    return out


def test_router_matches_jax():
    got = _same(_router_run)
    assert got["least_loaded"][:3] == ["b", "b", "a"]
    assert set(got["sticky"].values()) == {"v0", "v1"}
    assert got["fallback"] == "v0"


# ---------------------------------------------------------------------------
# from_env
# ---------------------------------------------------------------------------

ENV_CASES = {
    "disarmed": {},
    "zero": {"SMP_AUTOSCALE": "0"},
    "every_knob": {"SMP_AUTOSCALE": "on", "SMP_SLO": "queue_depth=3,ttft_p99_ms=250",
                   "SMP_AUTOSCALE_COOLDOWN": "1.5", "SMP_AUTOSCALE_MIN": "2", "SMP_AUTOSCALE_MAX": "5",
                   "SMP_AUTOSCALE_HYSTERESIS": "3", "SMP_CANARY_FRACTION": "0.1", "SMP_CANARY_WINDOWS": "4",
                   "SMP_CONTROLLER_PATH": "c.jsonl"},
    "bad_number": {"SMP_AUTOSCALE": "yes", "SMP_AUTOSCALE_COOLDOWN": "banana", "SMP_AUTOSCALE_MAX": "x"},
}
ENV_NAMES = sorted({k for env in ENV_CASES.values() for k in env})


def _from_env_run(ns):
    ctl = ns.serving.ServingController.from_env()
    if ctl is None:
        return None, list(ns.serving.controller._ACTIVE)
    p = ctl.policy
    out = (p.slo, p.cooldown_s, p.min_replicas, p.max_replicas, p.hysteresis, ctl.canary_fraction,
           ctl.canary_windows, ctl.path, ctl in ns.serving.controller._ACTIVE)
    ctl.stop()
    return out, ctl in ns.serving.controller._ACTIVE


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_from_env_matches_jax(monkeypatch, case):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in ENV_CASES[case].items():
        monkeypatch.setenv(name, value)
    got = _same(_from_env_run)
    assert (got[0] is None) == (case in ("disarmed", "zero"))


# ---------------------------------------------------------------------------
# Scale events over fake handles
# ---------------------------------------------------------------------------


def _controller(ns, path, clk, slo=None, **policy_kw):
    wins = []
    policy_kw.setdefault("cooldown_s", 0.0)
    policy_kw.setdefault("hysteresis", 2)
    S = ns.serving
    ctl = S.ServingController(router=S.RequestRouter(),
                              policy=S.AutoscalePolicy(slo or {"queue_depth": 2.0}, clock=clk, **policy_kw),
                              window_source=lambda: wins.pop(0) if wins else None, path=str(path), clock=clk)
    return ctl, wins


def _scale_up_run(ns, tmp_path):
    clk = FakeClock()
    path = tmp_path / f"{id(ns)}_up.jsonl"
    ctl, wins = _controller(ns, path, clk)
    ctl.register_live(FakeHandle("r0"))
    newh = FakeHandle("r1")

    def activate():
        clk.advance(0.5)
        return newh

    ctl.add_standby("r1", activate)
    out = []
    wins.append({"seq": 1, "queue_depth": 9})
    out.append(ctl.tick())
    clk.advance(1.0)
    wins.append({"seq": 2, "queue_depth": 9})
    out.append(ctl.tick())
    out.append(ctl.tick())  # no new window
    ev = ctl.scale_events[0]
    out.append((dict(ev["phases"]), "seconds" in ev, _feed(path)))
    clk.advance(0.25)
    newh._results["x"] = [1, 2]
    ctl.tick()
    out.append((dict(ev["phases"]), ev["seconds"], _timeless(ev), _feed(path), ctl.replicas, _gauges(ns)))
    ctl.stop()
    return out


def test_scale_up_matches_jax(tmp_path):
    got = _same(_scale_up_run, tmp_path)
    phases, seconds = got[-1][0], got[-1][1]
    assert got[1] == "up" and phases["trigger"] == pytest.approx(1.0) and seconds == pytest.approx(1.75)


def _no_standby_run(ns, tmp_path):
    clk = FakeClock()
    ctl, wins = _controller(ns, tmp_path / "none.jsonl", clk, hysteresis=1)
    ctl.register_live(FakeHandle("r0"))
    wins.append({"seq": 1, "queue_depth": 9})
    out = (ctl.tick(), ctl.replicas, ctl.scale_events)
    ctl.stop()
    return out


def test_scale_up_without_standby_matches_jax(tmp_path):
    assert _same(_no_standby_run, tmp_path) == (None, 1, [])


def _scale_down_run(ns, tmp_path):
    clk = FakeClock()
    path = tmp_path / f"{id(ns)}_down.jsonl"
    ctl, wins = _controller(ns, path, clk)
    a = ctl.register_live(FakeHandle("a"))
    b = ctl.register_live(FakeHandle("b"))
    b.stragglers = [_record("q1")]
    b._results = {"f1": [7, 8]}
    out = []
    wins.append({"seq": 1, "queue_depth": 0})
    out.append(ctl.tick())
    wins.append({"seq": 2, "queue_depth": 0})
    out.append(ctl.tick())
    out.append((b.drained, ctl.replicas, sorted(ctl.router.handles), [r.request_id for r in a.submitted],
                ctl.results(), [_timeless(e) for e in ctl.scale_events], _feed(path), _gauges(ns)))
    out.append((ctl.scale_down(), ctl.replicas))
    ctl.stop()
    return out


def test_scale_down_drain_matches_jax(tmp_path):
    got = _same(_scale_down_run, tmp_path)
    assert got[1] == "down" and got[2][3] == ["q1"] and got[3] == (None, 1)


def test_controller_calls_chaos_after_each_scale_event(tmp_path, monkeypatch):
    """``kill_replica@scale=2`` fires after the second finished event, in
    both packages (the kill itself patched out)."""
    monkeypatch.setenv("SMP_CHAOS", "kill_replica@scale=2")

    def run(ns, tmp_path):
        killed = []
        monkeypatch.setattr(ns.chaos.os, "kill", lambda pid, sig: killed.append(sig))
        ns.chaos.chaos.reset()
        clk = FakeClock()
        ctl, wins = _controller(ns, tmp_path / f"{id(ns)}_chaos.jsonl", clk, hysteresis=1)
        ctl.register_live(FakeHandle("a"))
        ctl.register_live(FakeHandle("b"))
        ctl.register_live(FakeHandle("c"))
        out = []
        for seq in (1, 2):
            wins.append({"seq": seq, "queue_depth": 0})
            out.append((ctl.tick(), len(killed)))
        ctl.stop()
        ns.chaos.chaos.reset()
        return out

    assert _same(run, tmp_path) == [("down", 0), ("down", 1)]


# ---------------------------------------------------------------------------
# A burst on real engines: scale 1 -> 2 -> 1 with token parity
# ---------------------------------------------------------------------------

ZOO = dict(vocab_size=97, max_len=64, d_model=32, n_layers=2, n_heads=4)
ENGINE_KW = dict(max_slots=2, block_tokens_override=4, prefill_chunk=4)
BURST = 16


def _prompts():
    rng = np.random.default_rng(300)
    return [list(map(int, rng.integers(0, ZOO["vocab_size"], 5))) for _ in range(8)]


@pytest.fixture(scope="module")
def zoo_params():
    # On the 8-device mesh of smp.init({}), where the JAX engines run (a mesh
    # another test file left behind in this process would commit the
    # parameters to its devices).
    jax_smp.reset()
    jax_smp.init({})
    jmod = JaxTransformerLM(**ZOO)
    params = jmod.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    jax_smp.reset()
    return jmod, params


def _engine_factory(name, zoo_params):
    jmod, params = zoo_params
    if name == "jax":
        return lambda: jax_serving.ServingEngine(jmod, params=params, **ENGINE_KW)
    tmod = TransformerLM(**ZOO)
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return lambda: port_serving.ServingEngine(tmod, params=tmod.state_dict(), device="cpu", **ENGINE_KW)


def _burst_run(name, zoo_params, tmp_path):
    """The burst on ``name``'s engines: (never-scaled tokens, controller
    tokens, decisions a tick, scale events and feed without times)."""
    ns = PACKAGES[name]
    S = ns.serving
    (jax_smp if name == "jax" else smp).init({}, **({} if name == "jax" else {"device": "cpu"}))
    make = _engine_factory(name, zoo_params)
    engines = []

    def mk():
        engines.append(make())
        return engines[-1]

    prompts = _prompts()
    try:
        reference = mk().run([S.ServeRequest(f"s{i}", prompts[i % 8], 6) for i in range(BURST)], timeout_s=300)
        clk = FakeClock()
        router = S.RequestRouter()
        tick = {"seq": 0}

        def window():
            tick["seq"] += 1
            depth = max((len(h.engine._queue) for h in router.live_handles()), default=0)
            return {"seq": tick["seq"], "queue_depth": depth}

        path = tmp_path / f"{name}_burst.jsonl"
        ctl = S.ServingController(
            router=router, policy=S.AutoscalePolicy({"queue_depth": 2.0}, min_replicas=1, max_replicas=2,
                                                    cooldown_s=0.3, hysteresis=2, clock=clk),
            window_source=window, path=str(path), clock=clk)
        ctl.register_live(S.LocalReplicaHandle("replica0", mk(), version=0))
        ctl.add_standby("replica1", lambda: S.LocalReplicaHandle("replica1", mk(), version=0))
        placed = [router.dispatch(S.ServeRequest(f"a{i}", prompts[i % 8], 6)) for i in range(BURST)]
        decisions = []
        for _ in range(400):
            busy = router.step_all()
            decisions.append(ctl.tick())
            clk.advance(0.1)
            if not busy and len(ctl.results()) >= BURST and ctl.replicas == 1:
                break
        events = [_timeless(dict(e, warm=None)) for e in ctl.scale_events]
        results = {k: list(v) for k, v in ctl.results().items()}
        ctl.stop()
        return (dict((k, list(v)) for k, v in reference.items()), results, placed, decisions, events,
                [dict(r, warm=None) if "warm" in r else r for r in _feed(path)])
    finally:
        for eng in engines:
            eng.close()
        (jax_smp if name == "jax" else smp).reset()


@pytest.fixture(scope="module")
def bursts(zoo_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("burst")
    return {name: _burst_run(name, zoo_params, tmp) for name in ("jax", "port")}


def test_burst_scales_up_then_drains_down(bursts):
    reference, results, placed, decisions, events, feed = bursts["port"]
    assert [e["direction"] for e in events] == ["up", "down"]
    assert set(events[0]["phases"]) >= {"trigger", "rendezvous", "warm_start", "first_token"}
    assert [r["kind"] for r in feed] == ["scale_event", "scale_event"]
    # Nothing dropped, nothing duplicated, across the scale-up and the drain.
    assert sorted(results) == sorted(f"a{i}" for i in range(BURST))
    for i in range(BURST):
        assert results[f"a{i}"] == reference[f"s{i}"], i
    assert placed == ["replica0"] * BURST


def test_burst_matches_jax(bursts):
    """The same decisions tick for tick, the same events and feed records,
    and the same tokens (the engines agree, PR 15's parity)."""
    jref, jres, jplaced, jdec, jev, jfeed = bursts["jax"]
    pref, pres, pplaced, pdec, pev, pfeed = bursts["port"]
    assert pdec == jdec
    assert pev == jev and pfeed == jfeed
    assert pplaced == jplaced
    assert pres == jres and pref == jref


def test_warm_start_counts_kernel_loads(monkeypatch):
    """The port's warm report: a scale-up's activation counts its kernel
    library loads by source (``ops/_build.load``), and reports none when it
    loads none."""
    from smdistributed_modelparallel_tpu_torch.ops import _build
    from smdistributed_modelparallel_tpu_torch.utils import exec_cache

    clk = FakeClock()
    ctl, wins = _controller(PACKAGES["port"], "", clk, hysteresis=1)
    ctl.path = None
    ctl.register_live(FakeHandle("a"))

    def activate():
        _build.COMPILE_EVENTS.append({"source": "disk_cache", "name": "dropout", "seconds": 0.01})
        return FakeHandle("b")

    ctl.add_standby("b", activate)
    mark = exec_cache.compile_event_mark()
    wins.append({"seq": 1, "queue_depth": 9})
    try:
        assert ctl.tick() == "up"
        assert ctl.scale_events[0]["warm"] == {"disk_cache": 1}
        assert exec_cache.compile_events_since(mark)[0]["source"] == "disk_cache"
    finally:
        del _build.COMPILE_EVENTS[mark:]
        ctl.stop()


# ---------------------------------------------------------------------------
# The canary on the port's engines
# ---------------------------------------------------------------------------


def test_canary_promotes_then_rolls_back(zoo_params, tmp_path, monkeypatch):
    """Unchanged weights pass the token-parity gate and promote after one
    clean window; weights corrupted by ``SMP_CHAOS=corrupt_weights`` roll
    back: the old version is restored and serves the reference tokens, the
    feed records started/promoted/rolled_back and ``slo_report
    --controller`` gates red on the rolled-back version."""
    import os
    import sys

    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import slo_report

    from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos

    smp.init({}, device="cpu")
    engine = _engine_factory("port", zoo_params)()
    prompts = _prompts()
    reference = engine.run([port_serving.ServeRequest(f"ref{i}", prompts[i], 6) for i in range(2)], timeout_s=300)
    params = {k: v.clone() for k, v in engine.params.items()}
    wins = []
    feed = tmp_path / "ctl.jsonl"
    ctl = port_serving.ServingController(
        router=port_serving.RequestRouter(), policy=port_serving.AutoscalePolicy({"queue_depth": 50.0}),
        window_source=lambda: wins.pop(0) if wins else None, path=str(feed), canary_fraction=0.25,
        canary_windows=1)
    ctl.register_live(port_serving.LocalReplicaHandle("primary", engine, version=0))
    pinned = [port_serving.ServeRequest(f"pin{i}", prompts[i], 6) for i in range(2)]
    try:
        assert ctl.start_canary({k: v.clone() for k, v in params.items()}, version=1, pinned=pinned) is True
        assert engine.weights_version == 1
        wins.append({"seq": 10, "queue_depth": 0.0})
        ctl.tick()
        assert ctl.canary is None and ctl.promotions == 1
        monkeypatch.setenv("SMP_CHAOS", "corrupt_weights@version=2")
        chaos.reset()
        assert ctl.start_canary({k: v.clone() for k, v in params.items()}, version=2, pinned=pinned) is False
        assert ctl.rollbacks == 1 and ctl.canary is None and engine.weights_version == 1
        out = engine.run([port_serving.ServeRequest("post", prompts[0], 6)], timeout_s=300)
        assert list(out["post"]) == list(reference["ref0"])
        recs = [json.loads(line) for line in open(feed)]
        assert [r["kind"] for r in recs].count("weight_update") == 2
        assert {(r.get("verdict"), r.get("version")) for r in recs if r["kind"] == "canary"} == {
            ("started", 1), ("promoted", 1), ("rolled_back", 2)}
        assert slo_report.main([str(feed), "--controller", "--check"]) == 1
        gauges = _gauges(PACKAGES["port"])
        assert gauges[("smp_canary_rollback_total", ())] == 1
        assert gauges[("smp_canary_promotions_total", ())] == 1
    finally:
        ctl.stop()
        chaos.reset()
        engine.close()
