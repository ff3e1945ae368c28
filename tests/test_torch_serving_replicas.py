"""The port's multi-process serving tier against the JAX package's engine.

Two CPU processes over the native host bus (``chip_smoke.run_ranks``, gloo
for ``smp.init``'s bring-up), each with its own ``ServingEngine`` on the zoo
``TransformerLM`` converted from the JAX package's init (fp32), after
``tests/test_multiprocess.py``'s two oracles:
  - **failover** (``test_serving_replica_failover``): each rank serves its
    half of a six-request trace through ``ReplicatedServingEngine``, under
    ``SMP_SUPERVISOR=on`` and ``SMP_CHAOS=kill_replica@request=2:rank=1``.
    Rank 1 dies by SIGKILL mid-decode; rank 0 re-admits its unfinished
    requests from the mirror shadow and finishes all six, a sampled stream
    among them, with the tokens of the JAX package's engine on the whole
    trace. The recovery closes with the phases ``detect``/``readmit``/
    ``first_token``, three requests re-admitted, six finished, and
    ``scripts/resilience_probe.py --recovery`` reads the dumps clean;
  - **remote autoscale** (``test_controller_autoscale_two_process``): rank 0
    runs the armed ``ServingController`` (``SMP_AUTOSCALE=on``) over a local
    replica; rank 1 parks as a ``ReplicaServer`` standby. A burst breaches
    the queue-depth SLO, the controller activates rank 1 over ``ROUTER_TX``
    (its ready frame shows no fresh compile), routes the rest of the burst,
    then drains it back and deactivates it (rank 1 exits 0). All twelve
    streams equal a never-scaled run's and the JAX engine's tokens, and the
    feed gates green through ``scripts/slo_report.py --controller``.
The windows are one per controller tick (seq + 1, the replicas' largest
load), so the decisions do not depend on the machine's speed.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.serving import ServeRequest as JaxServeRequest
from smdistributed_modelparallel_tpu.serving import ServingEngine as JaxServingEngine
from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.convert import params_from_jax

ZOO = dict(vocab_size=61, max_len=32, d_model=16, n_layers=2, n_heads=2)
ENGINE_KW = dict(max_slots=2, block_tokens_override=4, prefill_chunk=4)
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _prompt(seed, n):
    return list(map(int, np.random.default_rng(seed).integers(0, ZOO["vocab_size"], n)))


# Request i belongs to replica i % 2. Rank 1's streams are long enough that
# none finishes before the kill (its 2nd admitted request mid-decode); r3
# samples, so the survivor must continue its key schedule exactly.
FAILOVER_TRACE = [
    ("r0", _prompt(70, 5), 4, {}),
    ("r1", _prompt(71, 6), 10, {}),
    ("r2", _prompt(72, 4), 5, {}),
    ("r3", _prompt(73, 7), 9, dict(temperature=0.9, top_p=0.9, seed=11)),
    ("r4", _prompt(74, 5), 3, {}),
    ("r5", _prompt(75, 6), 8, {}),
]
# 16-token streams keep the first half of the burst in flight across
# several windows.
BURST_TRACE = [(f"b{i}", _prompt(90 + i, 4 + i % 3), 16, {}) for i in range(12)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's init (as the port's state dict) and its engine's
    tokens on both traces."""
    jax_smp.reset()
    jax_smp.init({})
    mod = JaxTransformerLM(**ZOO)
    params = mod.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    want = {}
    for trace in (FAILOVER_TRACE, BURST_TRACE):
        engine = JaxServingEngine(mod, params=params, **ENGINE_KW)
        got = engine.run([JaxServeRequest(rid, p, m, **kw) for rid, p, m, kw in trace], timeout_s=300)
        want.update({rid: list(map(int, got[rid])) for rid, *_ in trace})
        engine.close()
    jax_smp.reset()
    sd = {k: v.numpy().copy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray, params)).items()}
    return sd, want


def _engine_factory(state_dict):
    import torch

    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    module = TransformerLM(**ZOO)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return lambda: ServingEngine(module, params=module.state_dict(), device="cpu", **ENGINE_KW)


def _failover_worker(rank, world, state_dict, dump_dir):
    import time

    os.environ.update(SMP_SUPERVISOR="on", SMP_HEARTBEAT_INTERVAL="0.2", SMP_HEARTBEAT_MISS_BUDGET="5",
                      SMP_CHAOS="kill_replica@request=2:rank=1", SMP_COLLECTIVE_TIMEOUT="60")
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    smp.init({"ddp": True}, device="cpu")
    assert smp.supervisor.detector is not None
    rep = smp.serving.ReplicatedServingEngine(_engine_factory(state_dict)())
    mine = [smp.serving.ServeRequest(rid, p, m, **kw)
            for i, (rid, p, m, kw) in enumerate(FAILOVER_TRACE) if i % world == rank]
    results = rep.run(mine, timeout_s=240.0, linger_s=45.0 if rank == 0 else 0.0)
    assert rank == 0, "rank 1 should have been SIGKILLed mid-decode"
    # The bus's death mark can start the failover before the heartbeat
    # detector's miss budget runs out; its verdict is what is counted.
    deadline = time.monotonic() + 60.0
    while 1 not in smp.supervisor.failures() and time.monotonic() < deadline:
        time.sleep(0.05)
    report = telemetry.report()["metrics"]
    events = {s["labels"]["event"]: s["value"] for s in report["smp_serve_requests_total"]["series"]}
    kinds = {s["labels"]["kind"]: s["value"] for s in report["smp_failures_detected_total"]["series"]}
    out = dict(results={k: list(map(int, v)) for k, v in results.items()}, events=events, kinds=kinds,
               recoveries=report["smp_recoveries_total"]["series"][0]["value"],
               mttr=report["smp_recovery_seconds"]["series"][0]["value"])
    telemetry.dump(os.path.join(dump_dir, "telemetry.json"))
    flight_recorder.dump(os.path.join(dump_dir, f"flight.rank{rank}.jsonl"))
    smp.reset()
    return out


@pytest.fixture(scope="module")
def failover(jax_side, tmp_path_factory):
    dump_dir = str(tmp_path_factory.mktemp("failover"))
    per_rank = run_ranks(2, _failover_worker, jax_side[0], dump_dir, timeout=400, killed=(1,))
    return per_rank[0], dump_dir


def test_failover_survivor_serves_the_jax_tokens(jax_side, failover):
    _, want = jax_side
    got, _ = failover
    assert sorted(got["results"]) == sorted(rid for rid, *_ in FAILOVER_TRACE)
    for rid, *_ in FAILOVER_TRACE:
        assert got["results"][rid] == want[rid], rid
    assert got["events"].get("readmitted", 0) == 3, got["events"]
    assert got["events"].get("finished", 0) == 6, got["events"]
    assert got["recoveries"] == 1 and 0.0 < got["mttr"] < 120.0
    assert got["kinds"].get("dead", 0) >= 1, got["kinds"]


def test_failover_recovery_probe_reads_the_dumps(failover):
    _, dump_dir = failover
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import resilience_probe

    report = resilience_probe.recovery_report(dump_dir)
    assert report["problems"] == [], report["problems"]
    assert report["recoveries_total"] == 1
    rec = report["recoveries"][0]
    assert rec["mode"] == "serving", rec
    assert set(rec["phases"]) == {"detect", "readmit", "first_token"}


def _autoscale_worker(rank, world, state_dict, feed):
    import time

    os.environ.update(SMP_SUPERVISOR="on", SMP_COLLECTIVE_TIMEOUT="60")
    if rank == 0:
        os.environ.update(SMP_AUTOSCALE="on", SMP_SLO="queue_depth=2", SMP_AUTOSCALE_COOLDOWN="0.5",
                          SMP_AUTOSCALE_MIN="1", SMP_AUTOSCALE_MAX="2", SMP_AUTOSCALE_HYSTERESIS="2",
                          SMP_CONTROLLER_PATH=feed)
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    smp.init({"ddp": True}, device="cpu")
    factory = _engine_factory(state_dict)
    if rank == 1:
        results = smp.serving.ReplicaServer(factory, state.bus, controller_rank=0).serve(timeout_s=300.0)
        smp.reset()
        return dict(served=sorted(results))

    eng0 = factory()
    reference = eng0.run([smp.serving.ServeRequest(f"ref_{rid}", p, m) for rid, p, m, _ in BURST_TRACE],
                         timeout_s=240.0)
    router = smp.serving.RequestRouter()
    seq = [0]

    def window():
        seq[0] += 1
        return {"seq": seq[0], "t_wall": time.time(),
                "queue_depth": max((h.load() for h in router.live_handles()), default=0)}

    ctl = smp.serving.ServingController.from_env(router=router, window_source=window)
    assert ctl is not None, "SMP_AUTOSCALE=on must arm the controller"
    ctl.register_live(smp.serving.LocalReplicaHandle("replica0", eng0, version=0))
    remote = smp.serving.RemoteReplicaHandle("replica1", state.bus, peer=1, version=0)

    def activate():
        remote.activate(timeout_s=180.0)
        return remote

    ctl.add_standby("replica1", activate)
    reqs = [smp.serving.ServeRequest(rid, p, m) for rid, p, m, _ in BURST_TRACE]
    for req in reqs[:8]:
        assert router.dispatch(req)
    sent = 8
    deadline = time.monotonic() + 240.0
    while time.monotonic() < deadline:
        if sent < len(reqs) and ctl.replicas == 2:
            # The rest of the burst lands after the scale-up: least-loaded
            # routing sends some of it to the new replica.
            assert router.dispatch(reqs[sent])
            sent += 1
        busy = router.step_all()
        ctl.tick()
        if sent == len(reqs) and not busy and all(rid in ctl.results() for rid, *_ in BURST_TRACE):
            break
        if not busy:
            time.sleep(0.002)
    down_deadline = time.monotonic() + 60.0
    while ctl.replicas > 1 and time.monotonic() < down_deadline:
        router.step_all()
        ctl.tick()
        time.sleep(0.01)
    report = telemetry.report()["metrics"]
    out = dict(sent=sent, events=[{k: v for k, v in e.items() if k not in ("t_wall", "seconds")}
                                  for e in ctl.scale_events],
               results={k: list(map(int, v)) for k, v in ctl.results().items()},
               reference={k[len("ref_"):]: list(map(int, v)) for k, v in reference.items()},
               routed=dict(router.routed),
               directions={s["labels"]["direction"]: s["value"]
                           for s in report["smp_autoscale_events_total"]["series"]},
               replicas_gauge=report["smp_controller_replicas"]["series"][0]["value"])
    ctl.stop()
    smp.reset()
    return out


@pytest.fixture(scope="module")
def autoscale(jax_side, tmp_path_factory):
    feed = str(tmp_path_factory.mktemp("autoscale") / "controller.jsonl")
    return run_ranks(2, _autoscale_worker, jax_side[0], feed, timeout=400), feed


def test_remote_scale_up_then_drain(autoscale):
    (r0, r1), feed = autoscale
    assert r0["sent"] == len(BURST_TRACE)
    directions = [e["direction"] for e in r0["events"]]
    assert directions == ["up", "down"], directions
    up, down = r0["events"]
    # The activation's compile sources: nothing built fresh (the zoo engine
    # on the CPU loads no kernel library: an empty report).
    assert up["warm"].get("fresh", 0) == 0, up["warm"]
    assert set(up["phases"]) >= {"trigger", "rendezvous", "warm_start", "first_token"}, up["phases"]
    assert down["stragglers"] == 0 and set(down["phases"]) == {"drain", "reroute"}, down
    assert r0["routed"].get("replica1", 0) >= 1, r0["routed"]
    assert r0["directions"] == {"up": 1, "down": 1} and r0["replicas_gauge"] == 1
    assert set(r1["served"]) <= {rid for rid, *_ in BURST_TRACE} and r1["served"]
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import slo_report

    assert slo_report.main([feed, "--controller", "--check", "--max-scale-seconds", "180"]) == 0
    assert [json.loads(line)["kind"] for line in open(feed)] == ["scale_event", "scale_event"]


def test_remote_scale_tokens_match_reference_and_jax(jax_side, autoscale):
    _, want = jax_side
    (r0, _), _ = autoscale
    for rid, *_ in BURST_TRACE:
        assert r0["results"][rid] == r0["reference"][rid] == want[rid], rid
