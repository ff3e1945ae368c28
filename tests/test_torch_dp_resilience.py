"""Resilience across ranks on the CPU: preemption, the supervised shrink to
survivors and the fleet plane, over the port's native bus and gloo.

- SIGTERM to rank 1 of two at step edge 3 (``SMP_CHAOS=sigterm@step=3:
  rank=1``): the edge's agreement stops both ranks there, rank 0 takes rank
  1's notice off tx -2, both save the same ``preempt_step_3`` and exit 0; a
  fresh two-rank world resumes it and repeats an uninterrupted run's losses
  bit for bit. That world also runs the fleet plane: rank 0's merged
  ``smp_step_total`` equals ``scripts/telemetry_report.py``'s merge of both
  ranks' registries.
- The supervised kill of ``tests/test_multiprocess.py::
  test_supervised_kill_recovers_in_job`` (without its executable-cache
  assertions: ROADMAP item 10) at rdp = 2: rank 1 dies by SIGKILL at step
  edge 3, after two heartbeats dropped below the miss budget (which classify
  nothing); rank 0 gets ``SMPPeerLost``, agrees on ``step_2``, re-forms a
  world of one in-process and trains past step 3 on the same trajectory.
- A world of three (rdp = 3) that loses rank 2 and re-forms a default group
  of two (the survivors' rendezvous, a new gloo world at rank 0's endpoint).
- The fleet aggregator's failover, ``test_fleet_aggregator_failover`` on
  the port's plane and bus: rank 0 (the aggregator) is killed and rank 1
  takes the feed over.
"""

import json
import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest
import torch

from chip_smoke import _free_port

B, MB, STEPS = 12, 2, 6
ZOO = dict(vocab_size=64, max_len=16, d_model=32, n_layers=1, n_heads=4)
RESILIENCE_ENV = {"SMP_HEARTBEAT_INTERVAL": "0.1", "SMP_HEARTBEAT_MISS_BUDGET": "5", "SMP_COLLECTIVE_TIMEOUT": "10",
                  "SMP_CKPT_COMMIT_TIMEOUT": "60"}


def _entry(rank, world, port, env, target, args, conn):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), **env)
    torch.set_num_threads(1)
    try:
        target(rank, world, conn, *args)
    except SystemExit:
        raise
    except BaseException:
        import traceback

        conn.send(("err", traceback.format_exc()))
        raise


def _world(target, world, *args, env=None, timeout=240, kill=None):
    """Run ``target(rank, world, conn, *args)`` in ``world`` spawned ranks;
    return (each rank's messages, exit codes). ``kill(procs, conns)`` runs
    while they do."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    pipes = [ctx.Pipe() for _ in range(world)]
    procs = [ctx.Process(target=_entry, args=(r, world, port, env or {}, target, args, pipes[r][1]))
             for r in range(world)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()
    try:
        if kill is not None:
            kill(procs, [parent for parent, _ in pipes])
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    msgs = []
    for parent, _ in pipes:
        got = []
        while parent.poll(0):
            try:
                got.append(parent.recv())
            except EOFError:
                break
        msgs.append(got)
    return msgs, [p.exitcode for p in procs]


def _batch():
    return torch.from_numpy(np.random.default_rng(4).integers(0, 64, (B, 16)))


def _build():
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

    torch.manual_seed(0)
    model = smp.DistributedModel(TransformerLM(**ZOO), device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids):
        loss = model(ids[:, :-1], targets=ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    return model, opt, train_step


def _rows(ids):
    """This rank's rows of the global batch at the live rdp."""
    import smdistributed_modelparallel_tpu_torch as smp

    r, n = smp.rdp_rank(), smp.rdp_size()
    return ids[r * B // n:(r + 1) * B // n]


def _train(model, opt, train_step, steps):
    out = []
    for _ in range(steps):
        out.append(float(train_step(model, _rows(_batch())).reduce_mean()))
        opt.step()
    return out


# ----------------------------------------------------------------------
# SIGTERM on one rank of two, and the resume (with the fleet plane)
# ----------------------------------------------------------------------


def _sigterm_worker(rank, world, conn, root):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.resilience.preemption import preemption

    smp.init({"microbatches": MB, "ddp": True}, device="cpu")
    model, opt, train_step = _build()
    losses = []
    try:
        for _ in range(STEPS):
            losses.append(float(train_step(model, _rows(_batch())).reduce_mean()))
            opt.step()
    except SystemExit as e:
        conn.send(("exit", e.code, losses, preemption._requested, preemption.emergency_saved, state.step_count))
        raise
    conn.send(("no exit", losses))


def _resume_worker(rank, world, conn, root):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    smp.init({"microbatches": MB, "ddp": True}, device="cpu")
    model, opt, train_step = _build()
    want = _train(model, opt, train_step, 5)
    user = smp.resume_from_checkpoint(root, tag="preempt_step_3")
    got = _train(model, opt, train_step, 3)
    # The fleet plane: rank 0 aggregates both ranks' registries.
    mine = telemetry.report()
    totals = smp.allgather(_counter(mine, "smp_step_total"))
    merged = None
    if rank == 0:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            merged = fleet.plane.fleet_report()["merged"]
            if _counter(merged, "smp_step_total") == sum(totals):
                break
            time.sleep(0.05)
    smp.barrier()
    conn.send(("ok", want, got, user, mine, merged, fleet.plane.aggregator))
    smp.shutdown()


def _counter(report, name):
    fam = report.get("metrics", {}).get(name, {"series": []})
    return sum(s.get("value", 0) for s in fam["series"])


@pytest.fixture(scope="module")
def sigterm_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("preempt"))
    env = {**RESILIENCE_ENV, "SMP_CHAOS": "sigterm@step=3:rank=1", "SMP_EMERGENCY_CKPT_PATH": root}
    first = _world(_sigterm_worker, 2, root, env=env)
    fleet_env = {**RESILIENCE_ENV, "SMP_FLEET_INTERVAL": "0.2"}
    second = _world(_resume_worker, 2, root, env=fleet_env)
    return root, first, second


def test_sigterm_on_one_rank_saves_both_and_exits_zero(sigterm_run):
    root, (msgs, codes), _ = sigterm_run
    assert codes == [0, 0], msgs
    (r0,), (r1,) = msgs
    assert r0[0] == r1[0] == "exit" and r0[1] in (0, None) and r1[1] in (0, None)
    assert r1[3] == "sigterm" and r0[3] == "peer_notice"  # rank 0 took rank 1's notice off tx -2
    assert r0[4] == r1[4] == (root, "preempt_step_3")
    assert r0[5] == r1[5] == 3 and r0[2] == r1[2] and len(r0[2]) == 2
    d = os.path.join(root, "preempt_step_3_partial")
    assert {".committed", ".done_p0", ".done_p1", "model_shards_p0.npz", "model_shards_p1.npz"} <= set(os.listdir(d))
    with open(os.path.join(root, "newest")) as fh:
        assert fh.read() == "preempt_step_3"


def test_preempt_checkpoint_resumes_bit_equal(sigterm_run):
    _, (msgs, _), (resumed, codes) = sigterm_run
    assert codes == [0, 0], resumed
    for (ok, want, got, user, *_), (first,) in zip((m[0] for m in resumed), msgs):
        assert ok == "ok"
        assert user["step_count"] == 3
        assert want[:2] == first[2]  # the same trajectory before the preemption
        assert got == want[2:5]  # the third step's update was not applied before the save


def test_fleet_merge_matches_the_report_script(sigterm_run):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts", "telemetry_report.py"))
    report_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report_mod)
    _, _, (resumed, _) = sigterm_run
    (r0,), (r1,) = resumed
    offline = report_mod.aggregate({0: r0[4], 1: r1[4]})
    assert r0[6] == 0 and r0[5] is not None
    assert _counter(r0[5], "smp_step_total") == _counter(offline, "smp_step_total") == 16  # 8 steps a rank


# ----------------------------------------------------------------------
# The supervised kill: 2 -> 1 and 3 -> 2
# ----------------------------------------------------------------------


def _kill_worker(rank, world, conn, root):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPPeerLost
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    smp.init({"microbatches": MB, "ddp": True}, device="cpu")
    assert smp.supervisor.active and smp.supervisor.detector is not None
    model, opt, train_step = _build()
    losses, replay, report, error = {}, {}, None, None
    while state.step_count < STEPS:
        sc = state.step_count
        try:
            loss = float(train_step(model, _rows(_batch())).reduce_mean())
            opt.step()
        except Exception as e:
            if report is not None:
                raise
            error = type(e).__name__
            report = smp.supervisor.recover(error=e, ckpt_path=root, grace=60)
            model, opt, train_step = _build()
            continue
        (replay if report else losses)[sc] = loss
        if report is None and sc <= 1:
            smp.save_checkpoint(root, partial=True, blocking=True)
    rep = telemetry.report()["metrics"]
    kinds = {s["labels"]["kind"]: s["value"] for s in rep["smp_failures_detected_total"]["series"]}
    conn.send(("ok", losses, replay, {k: v for k, v in report.items() if k != "phases"}, error,
               dict(smp.supervisor.last_report["phases"]), rep["smp_recovery_seconds"]["series"][0]["value"],
               rep["smp_recoveries_total"]["series"][0]["value"], kinds, smp.size(), smp.rdp_size(),
               isinstance(SMPPeerLost(0), Exception)))
    smp.shutdown()


def _kill_run(tmp_path, world, victim):
    root = str(tmp_path / f"kill{world}")
    # A budget of 10 beats (1 s): the two dropped beats stay far below it even
    # when the parallel suite's load delays the beats around them (at 5, such
    # load once made a detector count two deaths for the one kill: a peer
    # classified dead, revived, then dead). The kill itself is seen at once:
    # the victim's link is marked down when its sockets close.
    env = {**RESILIENCE_ENV, "SMP_SUPERVISOR": "on", "SMP_HEARTBEAT_MISS_BUDGET": "10",
           "SMP_CHAOS": f"heartbeat_drop@count=2:rank={victim},kill@step=3:rank={victim}"}
    return _world(_kill_worker, world, root, env=env)


@pytest.fixture(scope="module")
def kill_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kill")
    return {2: _kill_run(tmp, 2, 1), 3: _kill_run(tmp, 3, 2)}


@pytest.mark.parametrize("world", [2, 3])
def test_supervised_kill_reforms_at_the_survivors(kill_runs, world):
    msgs, codes = kill_runs[world]
    victim = world - 1
    assert codes[victim] == -signal.SIGKILL, (codes, msgs)
    assert codes[:victim] == [0] * victim, msgs
    for rank in range(victim):
        (r,) = msgs[rank]
        (_, losses, replay, report, error, phases, mttr, recoveries, kinds, size, rdp, _) = r
        assert error == "SMPPeerLost"
        assert report["survivors"] == world - 1 and report["rank"] == rank
        assert report["tag"] == "step_2" and report["step"] == 2
        assert report["failures"] == {victim: "dead"}
        assert size == rdp == world - 1
        assert {0, 1} <= set(losses) and {2, 3, 4, 5} <= set(replay)
        for sc in set(losses) & set(replay):
            assert abs(replay[sc] - losses[sc]) < 1e-5, (losses, replay)
        assert 0.0 < mttr < 300.0 and recoveries == 1
        assert set(phases) == {"detect", "rendezvous", "reshard_load", "first_step"}
        # The two dropped heartbeats (below the budget of 10) classified
        # nothing: the one verdict is the death.
        assert kinds == {"dead": 1}, kinds


# ----------------------------------------------------------------------
# Fleet aggregator failover on the port's plane and bus
# ----------------------------------------------------------------------


def _fleet_worker(rank, world, conn, ports, fleet_path):
    os.environ["SMP_FLEET_INTERVAL"] = "0.3"
    os.environ["SMP_FLEET_PATH"] = fleet_path
    from smdistributed_modelparallel_tpu_torch.backend import native
    from smdistributed_modelparallel_tpu_torch.utils.fleet import FleetMetricsPlane
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import LATENCY_BUCKETS, TelemetryRegistry

    bus = native.MessageBus(native.load())
    bus.listen(ports[rank])
    bus.connect(rank, world, [f"127.0.0.1:{p}" for p in ports])
    reg = TelemetryRegistry()
    lat = reg.histogram("smp_serve_latency_seconds", buckets=LATENCY_BUCKETS)
    plane = FleetMetricsPlane.from_env(bus=bus, registry=reg)
    plane.start()
    assert plane.aggregator == 0
    deadline, took_over = time.monotonic() + 60.0, 0
    while time.monotonic() < deadline:
        lat.labels(kind="itl").observe(0.01 + 0.002 * rank)
        if rank == 1 and plane.is_aggregator:
            took_over += 1
            if len([w for w in plane.windows() if w["aggregator"] == 1]) >= 3:
                break
        time.sleep(0.05)
    assert rank == 1, "rank 0 outlived the kill"
    ok = took_over > 0 and plane.aggregator == 1 and bus.peer_down(0)
    plane.stop()
    bus.shutdown()
    conn.send(("ok" if ok else "no takeover", len(plane.windows())))


def test_fleet_aggregator_failover(tmp_path):
    fleet_path = str(tmp_path / "fleet.jsonl")
    ports = [_free_port(), _free_port()]

    def kill(procs, conns):
        # Kill the aggregator once rank 1 publishes to it: three windows, one
        # of which merged rank 1's snapshot. Three windows alone can come from
        # rank 0 before a slow-starting rank 1 has connected; its first send
        # then meets a dead port, and the bus retries a connect for its whole
        # 30 s budget before it marks the peer down.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                windows = [json.loads(ln) for ln in open(fleet_path) if ln.strip()]
                if len(windows) >= 3 and any(1 in w["ranks"] for w in windows):
                    break
            except (FileNotFoundError, ValueError):
                pass
            time.sleep(0.1)
        os.kill(procs[0].pid, signal.SIGKILL)

    msgs, codes = _world(_fleet_worker, 2, ports, fleet_path, kill=kill, timeout=120)
    assert codes == [-signal.SIGKILL, 0], (codes, msgs)
    assert msgs[1][0][0] == "ok", msgs
    windows = [json.loads(ln) for ln in open(fleet_path) if ln.strip()]
    aggs = [w["aggregator"] for w in windows]
    flip = aggs.index(1)
    assert 0 in aggs[:flip] and all(a == 1 for a in aggs[flip:]), aggs
    assert windows[flip]["resync"] is True and 0 in windows[flip]["dead"]
    assert all(w["ranks"] == [1] for w in windows[flip:])
    walls = sorted(w["t_wall"] for w in windows)
    assert max(b - a for a, b in zip(walls, walls[1:])) <= 2.0, walls
