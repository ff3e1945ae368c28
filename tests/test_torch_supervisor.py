"""The port's failure-recovery supervisor (``resilience/supervisor.py``)
against the JAX package's, on fake buses.

``FakeBus`` and ``RendezvousBus`` are copies of the JAX package's test
doubles (``tests/test_supervisor.py``): the same beat, link, notice and step
sequences drive both packages' ``FailureDetector`` under a fixed clock and
give the same classifications, flap clearings, marked counts and telemetry
(``smp_failures_detected_total``); both packages' ``_rendezvous`` and
``_agree_checkpoint`` over the same scripted exchanges give the same
survivors, agreed checkpoints and ``SMPEvicted``; and
``latest_committed_checkpoint`` reads the same directories the same way.
At world size 1 (no bus) the port's supervisor arms no detector, sets
``active`` under ``SMP_SUPERVISOR=on``, and ``recover(e)`` re-raises ``e``;
the world's rebuild primitives run there too (a one-process supervised
world started and abandoned, ``smp.init`` again at the same config). The
multi-rank recoveries are in ``tests/test_torch_dp_resilience.py``.
"""

import importlib
import json
import os
import pickle
import time

import pytest

import smdistributed_modelparallel_tpu_torch as smp_torch

PKGS = {"jax": "smdistributed_modelparallel_tpu", "port": "smdistributed_modelparallel_tpu_torch"}


def _sup(pkg):
    return importlib.import_module(PKGS[pkg] + ".resilience.supervisor")


def _exc(pkg):
    return importlib.import_module(PKGS[pkg] + ".utils.exceptions")


def _tel(pkg):
    return importlib.import_module(PKGS[pkg] + ".utils.telemetry").telemetry


class FakeBus:
    def __init__(self, world=2, rank=0):
        self.world, self.rank = world, rank
        self.sent = []        # (dest, payload, tx) of send_raw
        self.inbox = {}       # (src, tx) -> [payload, ...]
        self.down = set()
        self.send_rc = {}     # dest -> forced send_raw rc

    def send_raw(self, dest, payload, tx):
        self.sent.append((dest, payload, tx))
        return self.send_rc.get(dest, 0)

    def drain_bytes(self, src, tx, limit=256):
        return self.inbox.pop((src, tx), [])

    def poll(self, src, tx):
        return bool(self.inbox.get((src, tx)))

    def peer_down(self, peer):
        return peer in self.down

    def beat(self, src, seq, step, tx=-4):
        self.inbox.setdefault((src, tx), []).append(b"%d:%d" % (seq, step))


class RendezvousBus(FakeBus):
    """FakeBus + the barrier/exchange surface the rendezvous uses."""

    def __init__(self, world=3, rank=0):
        super().__init__(world=world, rank=rank)
        self.barrier_script = []   # per-call: None=ok, exc=raise
        self.barriers = []
        self.after_barrier = []    # (src, tx, obj) delivered post-barrier

    def barrier(self, ranks, timeout_ms=600000):
        self.barriers.append(list(ranks))
        if self.barrier_script:
            exc = self.barrier_script.pop(0)
            if exc is not None:
                raise exc
        for src, tx, obj in self.after_barrier:
            self.put(src, tx, obj)

    def send_bytes(self, dest, payload, tx):
        self.sent.append((dest, payload, tx))

    def recv_bytes(self, src, tx, timeout_ms=-1):
        q = self.inbox.get((src, tx))
        if q:
            return q.pop(0)
        raise TimeoutError(f"nothing from {src}")

    def put(self, src, tx, obj):
        self.inbox.setdefault((src, tx), []).append(json.dumps(obj).encode())


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SMP_SUPERVISOR", raising=False)
    # The rendezvous's coordinator endpoint names this host: the override,
    # so neither package probes a route for its address.
    monkeypatch.setenv("SMP_BUS_HOST", "127.0.0.1")
    for pkg in PKGS:
        _tel(pkg).reset()
    yield
    smp_torch.reset()
    for pkg in PKGS:
        _tel(pkg).reset()
        _sup(pkg).supervisor.reset()


def _detected(pkg):
    fam = _tel(pkg).report()["metrics"].get("smp_failures_detected_total", {"series": []})
    return sorted((s["labels"]["kind"], s["value"]) for s in fam["series"])


# Each scenario: a sequence of moves on a 3-process world seen from rank 0
# (peers 1 and 2): ("beat", src, seq, step), ("tick", now), ("my", step),
# ("down", peer), ("rc", peer, rc), ("notice", peer), ("recovering", flag),
# ("force", peer).
SCENARIOS = {
    "healthy": [m for i in range(10) for m in (("beat", 1, i, i), ("beat", 2, i, i), ("my", i), ("tick", i * 0.1))],
    "missed_budget": [("beat", 1, 0, 0), ("beat", 2, 0, 0), ("tick", 0.0), ("beat", 2, 1, 1), ("tick", 0.4),
                      ("beat", 2, 2, 2), ("tick", 0.6)],
    "flap_below_budget": [("beat", 1, 0, 0), ("tick", 0.0), ("tick", 0.2), ("tick", 0.45), ("beat", 1, 1, 1),
                          ("tick", 0.5), ("tick", 0.9)],
    "dead_then_revived": [("beat", 1, 0, 0), ("tick", 0.0), ("tick", 1.0), ("beat", 1, 1, 1), ("tick", 1.1)],
    "no_flap_clear_recovering": [("beat", 1, 0, 0), ("tick", 0.0), ("tick", 1.0), ("recovering", True),
                                 ("beat", 1, 1, 1), ("tick", 1.1)],
    "link_dead": [("rc", 1, -2), ("tick", 0.0)],
    "recv_down": [("down", 2), ("tick", 0.0)],
    "wedged": [m for i in range(25) for m in (("beat", 1, i, 3), ("beat", 2, i, i), ("my", 3 + i),
                                              ("tick", i * 0.1))],
    "wedged_then_advances": [m for i in range(25) for m in (("beat", 1, i, 3), ("my", 3 + i), ("tick", i * 0.1))]
    + [("beat", 1, 25, 30), ("tick", 2.6)],
    "slow_not_wedged": [m for i in range(25) for m in (("beat", 1, i, i // 8), ("my", i), ("tick", i * 0.1))],
    "idle_world": [m for i in range(25) for m in (("beat", 1, i, 3), ("my", 3), ("tick", i * 0.1))],
    "preempt_notice": [("notice", 1), ("tick", 0.0), ("tick", 5.0)],
    "force_dead": [("force", 2), ("force", 2), ("tick", 0.0)],
}


def _play(pkg, moves):
    mod = _sup(pkg)
    bus = FakeBus(world=3, rank=0)
    steps = {"n": 0}
    clock = {"t": 0.0}
    det = mod.FailureDetector(bus, my_step=lambda: steps["n"], interval=0.1, budget=5, wedge_s=1.0,
                              clock=lambda: clock["t"])
    preempt_tx = importlib.import_module(PKGS[pkg] + ".resilience.preemption").PREEMPT_NOTICE_TX
    trace = []
    for move in moves:
        kind, *args = move
        if kind == "beat":
            bus.beat(*args, tx=mod.HEARTBEAT_TX)
        elif kind == "tick":
            clock["t"] = args[0]
            det._tick(now=args[0])
            trace.append((args[0], dict(det.failures()), {p: st.kind for p, st in det.peers.items()},
                          det.marked_count))
        elif kind == "my":
            steps["n"] = args[0]
        elif kind == "down":
            bus.down.add(args[0])
        elif kind == "rc":
            bus.send_rc[args[0]] = args[1]
        elif kind == "notice":
            bus.inbox[(args[0], preempt_tx)] = [b"preempt"]
        elif kind == "recovering":
            det.recovering = args[0]
        elif kind == "force":
            det.force_dead(args[0], why="caller evidence")
    snap = det.snapshot()
    peers = {p: {k: v for k, v in st.items()} for p, st in snap["peers"].items()}
    sent = [(dest, payload, tx) for dest, payload, tx in bus.sent]
    return trace, peers, sent, _detected(pkg)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_detector_classifies_as_jax(name):
    want = _play("jax", SCENARIOS[name])
    got = _play("port", SCENARIOS[name])
    assert got == want
    assert _sup("port").HEARTBEAT_TX == _sup("jax").HEARTBEAT_TX == -4
    assert _sup("port").RECOVERY_TX == _sup("jax").RECOVERY_TX == -5


def _mk_ckpt(root, tag, step, committed=True):
    d = os.path.join(root, f"{tag}_partial")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "smp_config.pt"), "wb") as fh:
        pickle.dump({"step_count": step} if step is not None else {}, fh)
    if committed:
        with open(os.path.join(d, ".committed"), "w") as fh:
            fh.write(tag)


@pytest.mark.parametrize("layout", ["newest_pointer", "highest_step", "tag_parse", "empty", "missing"])
def test_latest_committed_checkpoint_as_jax(tmp_path, layout):
    root = str(tmp_path)
    if layout in ("newest_pointer", "highest_step"):
        _mk_ckpt(root, "a", 5)
        _mk_ckpt(root, "b", 7)
        _mk_ckpt(root, "c", 9, committed=False)
        if layout == "newest_pointer":
            with open(os.path.join(root, "newest"), "w") as fh:
                fh.write("a")
    elif layout == "tag_parse":
        _mk_ckpt(root, "step_12", None)
    elif layout == "missing":
        root = str(tmp_path / "nope")
    got = {pkg: _sup(pkg).latest_committed_checkpoint(root) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"] == {"newest_pointer": ("a", 5), "highest_step": ("b", 7), "tag_parse": ("step_12", 12),
                           "empty": None, "missing": None}[layout]


@pytest.mark.parametrize("infos", [{0: {"ckpt": ["step_7", 7]}, 2: {"ckpt": ["step_5", 5]}},
                                   {0: {"ckpt": ["step_7", 7]}, 2: {"ckpt": None}},
                                   {0: {"ckpt": ["b", 4]}, 2: {"ckpt": ["a", 4]}}])
def test_agree_checkpoint_as_jax(infos):
    out = {}
    for pkg in PKGS:
        sup = _sup(pkg).Supervisor()
        sup._recover_ckpt_path = "/nonexistent"
        try:
            out[pkg] = sup._agree_checkpoint(infos, [0, 2])
        except _exc(pkg).SMPRecoveryError as e:
            out[pkg] = ("SMPRecoveryError", str(e))
    assert out["port"] == out["jax"]


def _rendezvous(pkg, case, tmp_path):
    mod = _sup(pkg)
    sup = mod.Supervisor()
    sup._recover_ckpt_path = str(tmp_path)
    bus = RendezvousBus(world=3, rank=0)
    failures = {1: mod.DEAD}
    if case == "converges":
        bus.after_barrier = [(2, mod.RECOVERY_TX, {"rank": 2, "failed": [1], "step": 4, "ckpt": ["step_3", 3]})]
    elif case == "dies_at_barrier":
        bus.barrier_script = [_exc(pkg).SMPPeerLost(2)]
    elif case == "evicted":
        bus.after_barrier = [(2, mod.RECOVERY_TX, {"rank": 2, "failed": [0, 1], "step": 4, "ckpt": ["step_3", 3]})]
    elif case == "union_grows":
        bus.after_barrier = [(2, mod.RECOVERY_TX, {"rank": 2, "failed": [1], "step": 4, "ckpt": ["step_3", 3]}),
                             (3, mod.RECOVERY_TX, {"rank": 3, "failed": [1, 2], "step": 4, "ckpt": ["step_3", 3]})]
        bus.world = 4
    survivors = [0, 2] if case != "union_grows" else [0, 2, 3]
    try:
        got, infos = sup._rendezvous(bus, survivors, failures, 5.0)
    except _exc(pkg).SMPEvicted as e:
        return ("SMPEvicted", str(e))
    views = {r: {k: v for k, v in info.items() if k != "coord"} for r, info in infos.items()}
    return got, views, "coord" in infos[0], failures, bus.barriers, [(d, tx) for d, _, tx in bus.sent]


@pytest.mark.parametrize("case", ["converges", "dies_at_barrier", "dies_before_info", "evicted", "union_grows"])
def test_rendezvous_as_jax(tmp_path, case):
    _mk_ckpt(str(tmp_path), "step_3", 3)
    assert _rendezvous("port", case, tmp_path) == _rendezvous("jax", case, tmp_path)


def test_recover_reraises_a_non_peer_error_and_refuses_without_detector(monkeypatch):
    monkeypatch.setenv("SMP_EMERGENCY_CKPT_PATH", "/nonexistent")
    for pkg in PKGS:
        mod = _sup(pkg)
        sup = mod.Supervisor()
        sup.detector = mod.FailureDetector(FakeBus(), my_step=lambda: 0, interval=0.01, budget=1, wedge_s=1.0,
                                           clock=time.monotonic)
        aborts = []
        monkeypatch.setattr(sup, "_abort", lambda r: aborts.append(r))
        boom = ValueError("oom-ish")
        with pytest.raises(ValueError) as ei:
            sup.recover(error=boom)
        assert ei.value is boom and aborts == [] and not sup.detector.recovering and not sup._recovering
        bare = mod.Supervisor()
        with pytest.raises(ValueError) as ei:
            bare.recover(error=boom)
        assert ei.value is boom
        with pytest.raises(_exc(pkg).SMPRecoveryError, match="no armed detector"):
            bare.recover()


def test_world_size_one_under_smp_init(monkeypatch):
    from smdistributed_modelparallel_tpu_torch.resilience.supervisor import supervisor

    smp_torch.init({}, device="cpu")
    assert supervisor.active is False and supervisor.detector is None
    smp_torch.reset()
    monkeypatch.setenv("SMP_SUPERVISOR", "on")
    smp_torch.init({}, device="cpu")
    assert supervisor.active is True and supervisor.detector is None and supervisor.failures() == {}
    supervisor.on_step_edge()  # nothing pending, no detector: a no-op
    err = RuntimeError("a step failed")
    with pytest.raises(RuntimeError) as ei:
        supervisor.recover(err)
    assert ei.value is err
    import socket

    import torch.distributed as dist

    from smdistributed_modelparallel_tpu_torch.backend.state import state

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(name, os.environ.get(name, "x"))  # restored after the test
    cfg, device = state.cfg, state.device
    supervisor._teardown_world(state)
    supervisor._abandon_distributed()
    supervisor.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    assert dist.is_initialized() and dist.get_world_size() == 1 and os.environ["WORLD_SIZE"] == "1"
    supervisor._abandon_distributed()
    assert not dist.is_initialized()
    supervisor._clear_runtime(1)
    supervisor._reinit_framework(state, None)
    assert state.cfg is cfg and state.device == device and state.world_size == 1 and state.topology.size == 1
    smp_torch.reset()


def test_pending_recovery_closes_at_the_first_step_as_jax():
    reports = {}
    for pkg in PKGS:
        sup = _sup(pkg).Supervisor()
        now = time.monotonic()
        sup._await_first_step = {"survivors": 1, "t_detect": now - 4.0, "t_resume_done": now - 1.0,
                                 "phases": {"detect": 1.0, "rendezvous": 0.5, "reshard_load": 1.5}}
        sup.active = True
        sup.on_step_edge()
        assert sup._await_first_step is None and sup.last_report is not None
        rep = _tel(pkg).report()["metrics"]
        reports[pkg] = (sorted(s["labels"]["phase"] for s in rep["smp_recovery_phase_seconds"]["series"]),
                        rep["smp_recoveries_total"]["series"][0]["value"],
                        3.5 < rep["smp_recovery_seconds"]["series"][0]["value"] < 10.0)
    assert reports["port"] == reports["jax"] == (["detect", "first_step", "rendezvous", "reshard_load"], 1.0, True)
