"""In-job failure recovery of the PyTorch port: the heartbeat failure
detector and the shrink-to-survivors restart supervisor.

Counterpart of ``smdistributed_modelparallel_tpu/resilience/supervisor.py``,
with the same env vars (``SMP_SUPERVISOR``, ``SMP_HEARTBEAT_INTERVAL``,
``SMP_HEARTBEAT_MISS_BUDGET``, ``SMP_WEDGE_TIMEOUT``), reserved tx ids,
failure kinds, metrics and ring events.

**Failure detector** (``FailureDetector``). A daemon thread per process
exchanges heartbeats over the host bus on reserved control tx ``-4`` every
``SMP_HEARTBEAT_INTERVAL`` seconds; each beat carries the sender's step edge.
Per-peer last-seen tracking classifies a failed peer as

- **dead**: the bus marked the link down, or the peer missed
  ``SMP_HEARTBEAT_MISS_BUDGET`` consecutive beats. A peer that resumes
  beating before recovery begins is un-marked (``flap_cleared``);
- **wedged**: beats still arrive but the peer's step edge has not advanced
  for ``SMP_WEDGE_TIMEOUT`` seconds while this rank's edge moved past it;
- **preempted**: the peer posted the preemption notice (tx ``-2``); the
  preemption flow owns that path and the supervisor only reports it.

**Recovery protocol** (``supervisor.recover()``): wait (bounded) for a
classification, meet the survivors at a grace-bounded host-bus barrier and
exchange views (``_rendezvous``), agree on the newest checkpoint committed
on every survivor (``_agree_checkpoint``, ``latest_committed_checkpoint``),
send evicted-but-alive peers a notice (tx ``-5``), then reform the world at
the survivors and ``resume_from_checkpoint(elastic=True)``.

The host bus is ``state.bus``, the native bus (``backend/native.py``) that
``smp.init`` brings up at world > 1 (the detector, the rendezvous and the
agreement run over any object with its ``poll``/``send_bytes``/``send_raw``/
``recv_bytes``/``drain_bytes``/``barrier``/``peer_down``/``rank``/``world``,
and the tests also hold them on a fake bus). At one rank ``start()`` arms no
detector and, under ``SMP_SUPERVISOR=on``, sets ``active`` for the step-edge
hook, as the JAX package does on a one-process world; ``recover(error)``
re-raises the caller's error untouched.

Re-forming the world, in-process: ``_teardown_world`` closes the old bus;
``_abandon_distributed`` drops the old ``torch.distributed`` world without a
collective on it (gloo's ``destroy_process_group`` returns at once with a
dead peer); ``initialize_distributed`` starts a new default group at the
coordinator endpoint the lowest survivor published in the rendezvous, at the
survivors' world size (none for a world of one); ``_reinit_framework`` runs
``smp.init`` there (the old config, or plain data parallelism when it does
not fit), which brings a new bus up and re-arms the detector; then
``resume_from_checkpoint(elastic=True)``. A collective in flight when a peer
dies raises at the socket's EOF (gloo) or at ``SMP_COLLECTIVE_TIMEOUT``, and
the step turns it into the ``SMPPeerLost`` that ``recover`` accepts. A
supervised job may start its world with ``initialize_distributed`` or with
the launcher variables.

Detections land in ``smp_failures_detected_total{kind=}`` and the flight
recorder (``supervisor`` events); a recovery in ``smp_recoveries_total``,
``smp_recovery_seconds`` and ``smp_recovery_phase_seconds``. Heartbeats are
host-thread traffic only, and ``SMP_SUPERVISOR=off`` (the default) starts no
thread, sends no bytes and leaves the step path at one attribute test.

Import-hygiene contract: stdlib + package modules only at import time.
"""

import json
import os
import socket
import threading
import time

from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.resilience.preemption import (
    PREEMPT_NOTICE_TX,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPEvicted,
    SMPPeerLost,
    SMPRecoveryError,
    SMPWatchdogTimeout,
)
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import (
    flight_recorder,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    record_failure_detected,
    record_recovery,
    watchdog,
)

logger = get_logger()

SUPERVISOR_ENV = "SMP_SUPERVISOR"
HEARTBEAT_INTERVAL_ENV = "SMP_HEARTBEAT_INTERVAL"
MISS_BUDGET_ENV = "SMP_HEARTBEAT_MISS_BUDGET"
WEDGE_TIMEOUT_ENV = "SMP_WEDGE_TIMEOUT"

# Reserved control txs (-1..-33 namespace; see resilience/preemption.py):
# exit relay -1, preempt notice -2, step-edge exchange -3.
HEARTBEAT_TX = -4
RECOVERY_TX = -5

# Failure kinds.
DEAD = "dead"
WEDGED = "wedged"
PREEMPTED = "preempted"


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r; using %s.",
                       name, os.environ.get(name), default)
        return float(default)


def supervisor_enabled():
    return os.environ.get(SUPERVISOR_ENV, "off").lower() in ("on", "1", "true")


def heartbeat_interval():
    return max(_env_float(HEARTBEAT_INTERVAL_ENV, 0.5), 0.01)


def miss_budget():
    return max(int(_env_float(MISS_BUDGET_ENV, 5)), 1)


def wedge_timeout():
    return max(_env_float(WEDGE_TIMEOUT_ENV, 60.0), 0.1)


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _PeerState:
    __slots__ = ("last_beat", "last_step", "last_advance", "kind",
                 "detected_at", "link_dead", "beats")

    def __init__(self):
        self.last_beat = None      # monotonic time of the last beat
        self.last_step = None      # peer's reported step edge
        self.last_advance = None   # monotonic time the edge last moved
        self.kind = None           # None=healthy, else DEAD/WEDGED/PREEMPTED
        self.detected_at = None
        self.link_dead = False
        self.beats = 0

    def snapshot(self):
        return {
            "kind": self.kind, "beats": self.beats,
            "last_beat": self.last_beat, "last_step": self.last_step,
            "last_advance": self.last_advance,
            "detected_at": self.detected_at, "link_dead": self.link_dead,
        }


class FailureDetector:
    """Heartbeat sender + per-peer classifier.

    One ``_tick`` per interval: send a beat to every peer (chaos seam:
    ``heartbeat_drop``), drain every peer's pending beats, classify.
    ``clock`` and manual ``_tick`` calls exist for the unit tests; the
    production path runs ``_tick`` on a daemon thread.
    """

    def __init__(self, bus, my_step, interval=None, budget=None,
                 wedge_s=None, clock=time.monotonic):
        self.bus = bus
        self.world = bus.world
        self.rank = bus.rank
        self.interval = heartbeat_interval() if interval is None else interval
        self.budget = miss_budget() if budget is None else budget
        self.wedge_s = wedge_timeout() if wedge_s is None else wedge_s
        self._my_step = my_step
        self._clock = clock
        self.peers = {
            p: _PeerState() for p in range(self.world) if p != self.rank
        }
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        self.recovering = False  # suspends flap-clearing mid-recovery
        # Peers currently carrying ANY classification (incl. preempted):
        # the step-edge hook short-circuits on this instead of walking
        # every peer per step (O(world) matters at pod scale).
        self.marked_count = 0

    # -- lifecycle ------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="smp-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self):
        """Stop the heartbeat thread and WAIT for it: the caller tears
        the native bus down next, and a straggling tick still inside a
        ctypes bus call would touch freed C state. Ticks check the stop
        event between bus operations, so the join normally returns in
        milliseconds; a thread that outlives the full wait is logged
        loudly (teardown proceeds — the alternative is hanging recovery
        forever)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
            if t.is_alive():
                t.join(timeout=25.0)
            if t.is_alive():
                logger.error(
                    "heartbeat detector thread failed to stop within 30s; "
                    "proceeding with teardown (native bus calls from the "
                    "straggler may crash)."
                )

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # pragma: no cover - must never die
                logger.warning("heartbeat detector tick failed: %s", e)
            self._stop.wait(self.interval)

    # -- one scan -------------------------------------------------------

    def _tick(self, now=None):
        now = self._clock() if now is None else now
        my_step = int(self._my_step())
        self._seq += 1
        payload = b"%d:%d" % (self._seq, my_step)
        for p, st in self.peers.items():
            if self._stop.is_set():
                # stop() is about to tear the bus down under us.
                return
            if not chaos.on_heartbeat(p):
                rc = self.bus.send_raw(p, payload, HEARTBEAT_TX)
                if rc == -2:
                    st.link_dead = True
            for raw in self.bus.drain_bytes(p, HEARTBEAT_TX):
                try:
                    _, _, step_s = raw.partition(b":")
                    step = int(step_s)
                except ValueError:
                    continue
                st.beats += 1
                st.last_beat = now
                st.link_dead = False  # a live frame is proof of life
                if st.last_step is None or step != st.last_step:
                    st.last_step = step
                    st.last_advance = now
            if self.bus.peer_down(p):
                st.link_dead = True
            self._classify(p, st, now, my_step)

    def _classify(self, p, st, now, my_step):
        if st.kind == PREEMPTED:
            return
        if st.kind is not None:
            # Flap suppression, part 2: a peer marked failed that shows
            # fresh life BEFORE recovery starts is un-marked (a marked
            # peer whose beats resume mid-recovery stays excluded — the
            # survivors already committed to a world without it; it gets
            # an eviction notice instead).
            if self.recovering:
                return
            revived = (
                st.kind == DEAD
                and not st.link_dead
                and st.last_beat is not None
                and st.detected_at is not None
                and st.last_beat > st.detected_at
            ) or (
                st.kind == WEDGED
                and st.last_advance is not None
                and st.detected_at is not None
                and st.last_advance > st.detected_at
            )
            if revived:
                logger.warning(
                    "failure detector: process %d revived (%s cleared).",
                    p, st.kind,
                )
                record_failure_detected("flap_cleared", p, detail=st.kind)
                st.kind = None
                st.detected_at = None
                self.marked_count = max(self.marked_count - 1, 0)
            return
        if self.bus.poll(p, PREEMPT_NOTICE_TX):
            # Frame deliberately left in the inbox: the preemption listener
            # consumes it at the next step edge and drives the coordinated
            # emergency save. The supervisor only classifies/reports.
            self._mark(p, st, now, PREEMPTED, "preempt notice pending")
            return
        if st.link_dead:
            self._mark(p, st, now, DEAD, "link marked down")
        elif (
            st.last_beat is not None
            and now - st.last_beat > self.interval * self.budget
        ):
            self._mark(
                p, st, now, DEAD,
                f"missed-beat budget exhausted "
                f"({now - st.last_beat:.2f}s > {self.budget}x"
                f"{self.interval:g}s)",
            )
        elif (
            st.last_beat is not None
            and st.last_advance is not None
            and st.last_step is not None
            and my_step > st.last_step
            and now - st.last_advance > self.wedge_s
        ):
            self._mark(
                p, st, now, WEDGED,
                f"step edge stuck at {st.last_step} for "
                f"{now - st.last_advance:.2f}s (> {self.wedge_s:g}s) while "
                f"this rank reached {my_step}",
            )

    def _mark(self, p, st, now, kind, why):
        st.kind = kind
        st.detected_at = now
        self.marked_count += 1
        logger.error(
            "failure detector: process %d classified %s (%s).", p, kind, why
        )
        record_failure_detected(kind, p, detail=why)

    # -- queries --------------------------------------------------------

    def failures(self, kinds=(DEAD, WEDGED)):
        return {p: st.kind for p, st in self.peers.items()
                if st.kind in kinds}

    def force_dead(self, p, why="caller evidence"):
        st = self.peers.get(p)
        if st is not None and st.kind is None:
            self._mark(p, st, self._clock(), DEAD, why)

    def snapshot(self):
        return {
            "rank": self.rank, "world": self.world,
            "interval": self.interval, "budget": self.budget,
            "wedge_timeout": self.wedge_s, "seq": self._seq,
            "peers": {p: st.snapshot() for p, st in self.peers.items()},
        }


class Supervisor:
    """Singleton driving detection + in-job shrink-to-survivors recovery."""

    def __init__(self):
        self.active = False          # step.py's one-attribute-test guard
        self.detector = None
        self._recovering = False
        self._await_first_step = None   # pending MTTR closure
        self._recover_ckpt_path = None  # set per recover() call
        self.last_report = None
        self._world = None  # (rank, world) of the next smp.init, set by a supervised bring-up

    # -- lifecycle (state.initialize / smp.shutdown) --------------------

    def start(self):
        """Arm the detector if ``SMP_SUPERVISOR=on``, the world is
        multi-process, and the native bus is up. Idempotent; re-arms on a
        re-initialized world. A disabled supervisor starts nothing and
        leaves ``active`` False — the step path stays at one attribute
        test and the bus carries zero heartbeat traffic."""
        if not supervisor_enabled():
            self._stop_detector()
            self.active = bool(self._await_first_step)
            return False
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        bus = state.bus
        if bus is None or bus.world <= 1:
            self._stop_detector()
            # Still "active" for the step-edge seam: a pending recovery's
            # first-step closure (world may have shrunk to 1), and the
            # eviction check need the edge hook.
            self.active = True
            return False
        self._stop_detector()
        self.detector = FailureDetector(
            bus, my_step=lambda: _state().step_count
        )
        self.detector.start()
        self.active = True
        flight_recorder.record_supervisor(
            "armed", detail=f"world={bus.world} interval="
            f"{self.detector.interval:g}s budget={self.detector.budget}"
        )
        return True

    def stop(self):
        self._stop_detector()
        self.active = False

    def _stop_detector(self):
        d, self.detector = self.detector, None
        if d is not None:
            d.stop()

    def reset(self):
        """Session-teardown hook (resilience.reset)."""
        self.stop()
        self._recovering = False
        self._await_first_step = None
        self.last_report = None

    # -- step-edge seam (step.py; guarded by `.active`) -----------------

    def on_step_edge(self):
        """Called once per completed step when ``active``: closes a
        pending recovery's MTTR measurement, surfaces eviction notices,
        and turns a pending failure into a typed raise so the training
        loop never enters a doomed dispatch."""
        pending = self._await_first_step
        if pending is not None:
            now = time.monotonic()
            pending["phases"]["first_step"] = now - pending["t_resume_done"]
            mttr = now - pending["t_detect"]
            record_recovery(
                mttr, phases=pending["phases"],
                survivors=pending["survivors"],
            )
            logger.warning(
                "RECOVERY complete: first step trained %.2fs after "
                "detection (phases: %s).", mttr,
                {k: round(v, 3) for k, v in pending["phases"].items()},
            )
            self._await_first_step = None
            self.last_report = pending
            if self.detector is None:
                self.active = supervisor_enabled()
        if self.detector is None:
            return
        if not self.detector.marked_count:
            # Steady state: one integer test per edge. Eviction notices
            # can only await a rank the survivors classified failed — by
            # then THIS rank's links to them are down and marked.
            return
        self._check_evicted()
        failures = self.detector.failures()
        if failures and not self._recovering:
            peer, kind = next(iter(failures.items()))
            raise SMPPeerLost(
                peer,
                f"failure detector: process {peer} is {kind} (all: "
                f"{failures}); call smp.supervisor.recover() to reform "
                "the world from the survivors.",
            )

    def _check_evicted(self):
        bus = self.detector.bus if self.detector else None
        if bus is None:
            return
        for p in range(bus.world):
            if p == bus.rank:
                continue
            while bus.poll(p, RECOVERY_TX):
                try:
                    frame = json.loads(bus.recv_bytes(p, RECOVERY_TX, 0))
                except Exception:
                    break
                if frame.get("evict"):
                    flight_recorder.record_supervisor(
                        "evicted", peer=p,
                        detail=f"survivors={frame.get('survivors')}",
                    )
                    raise SMPEvicted(
                        f"process {bus.rank} was classified "
                        f"{frame.get('kind', 'failed')} and the survivors "
                        f"({frame.get('survivors')}) reformed the world "
                        "without it; exiting instead of training split-"
                        "brain."
                    )

    def failures(self):
        return dict(self.detector.failures()) if self.detector else {}

    # -- the supervised world --------------------------------------------

    def initialize_distributed(self, coordinator_address, num_processes,
                               process_id, init_timeout=120):
        """Start the ``torch.distributed`` default group (gloo) of a
        supervised world at ``coordinator_address`` ("host:port", hosted by
        process 0), with the ``SMP_COLLECTIVE_TIMEOUT`` timeout (else
        ``init_timeout`` seconds) so that a collective with a dead peer
        raises. The heartbeats, not the store, detect failures, and a failed
        world is abandoned without a collective (``_abandon_distributed``).
        ``smp.init`` then runs in the world this starts."""
        import datetime

        import torch.distributed as dist

        if dist.is_initialized():
            raise SMPRecoveryError(
                "torch.distributed is already initialized; a supervised bring-up must come before any other "
                "init_process_group call."
            )
        timeout = _collective_timeout() or float(init_timeout)
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id, timeout=datetime.timedelta(seconds=timeout))
        self._world = (process_id, num_processes)
        # A later smp.init (and the launcher-variable readers) see this world.
        host, port = coordinator_address.rsplit(":", 1)
        os.environ.update(RANK=str(process_id), WORLD_SIZE=str(num_processes), MASTER_ADDR=host, MASTER_PORT=port)
        logger.info("supervised torch.distributed world up: %s (%d/%d).", coordinator_address, process_id,
                    num_processes)

    # -- recovery -------------------------------------------------------

    def recover(self, error=None, new_config=None, ckpt_path=None,
                grace=None):
        """Reform the world from the survivors and resume from the agreed
        committed checkpoint. Returns a report dict (survivors, agreed
        tag/step, phase durations). The caller rebuilds its model/
        optimizer/step objects afterwards — the resumed state applies to
        them on their first step. Raises ``SMPRecoveryError`` (after
        dumping detector state + the flight ring) when the world cannot
        be reformed; re-raises ``error`` when no peer failure exists."""
        if self.detector is None:
            if error is not None:
                raise error
            raise SMPRecoveryError(
                "supervisor.recover() called with no armed detector "
                "(SMP_SUPERVISOR=off, single-process world, or bus down)."
            )
        if self._recovering:
            raise SMPRecoveryError("recovery already in progress.")
        grace = grace if grace is not None else (
            _collective_timeout() or 60.0
        )
        t_enter = time.monotonic()
        self._recovering = True
        self.detector.recovering = True
        try:
            return self._recover(error, new_config, ckpt_path, grace,
                                 t_enter)
        except SMPRecoveryError as e:
            self._abort(str(e))
            raise
        except SMPEvicted:
            raise  # peers reformed without this rank: exit, don't wrap
        except Exception as e:
            if e is error:
                # No peer failure behind it: the caller's original error
                # goes back UNTOUCHED (no abort dump, no wrapper) — an
                # ordinary OOM/bug is not a recovery failure.
                raise
            self._abort(f"{type(e).__name__}: {e}")
            raise SMPRecoveryError(
                f"in-job recovery failed: {type(e).__name__}: {e}"
            ) from e
        finally:
            self._recovering = False
            # The detector survives a FAILED recovery attempt (success
            # stops it before the world re-init): re-enable flap-clearing
            # or a transiently-marked peer could never be un-marked and
            # every later step edge would re-raise forever.
            if self.detector is not None:
                self.detector.recovering = False

    def _recover(self, error, new_config, ckpt_path, grace, t_enter):
        from smdistributed_modelparallel_tpu_torch.backend.state import state
        from smdistributed_modelparallel_tpu_torch.resilience.preemption import (
            EMERGENCY_PATH_ENV,
        )

        detector = self.detector
        bus = detector.bus
        old_rank, old_world = bus.rank, bus.world
        ckpt_path = ckpt_path or os.environ.get(EMERGENCY_PATH_ENV)
        if not ckpt_path:
            raise SMPRecoveryError(
                "recovery needs a checkpoint root: pass "
                "recover(ckpt_path=...) or set SMP_EMERGENCY_CKPT_PATH."
            )
        self._recover_ckpt_path = ckpt_path
        flight_recorder.record_supervisor(
            "recover_begin", detail=f"world={old_world} error="
            f"{type(error).__name__ if error else None}"
        )
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        # Phase 1: detection. Bounded wait for a classification; a typed
        # SMPPeerLost from the caller is direct evidence.
        with goodput.scope("recovery_detect"):
            failures = self._await_detection(detector, error)
        if not failures:
            if error is not None:
                raise error
            raise SMPRecoveryError("no peer failure detected or supplied.")
        now = time.monotonic()
        detect_s = max(
            (now - (detector.peers[p].detected_at or now))
            for p in failures
        )
        t_detect = now - detect_s
        logger.error(
            "RECOVERY: failures %s at world=%d; reforming from the "
            "survivors.", failures, old_world,
        )
        # Phase 2: survivor rendezvous over the (still-live) old bus.
        t0 = time.monotonic()
        with goodput.scope("recovery_rendezvous"):
            survivors = sorted(
                p for p in range(old_world) if p not in failures
            )
            survivors, infos = self._rendezvous(
                bus, survivors, failures, grace
            )
            tag, step = self._agree_checkpoint(infos, survivors)
            coord = next(
                (i.get("coord") for i in infos.values() if i.get("coord")),
                None,
            )
            self._notify_evicted(bus, failures, survivors)
        rendezvous_s = time.monotonic() - t0
        flight_recorder.record_supervisor(
            "rendezvous_ok",
            detail=f"survivors={survivors} tag={tag} step={step}",
        )
        # Phase 3: tear down the failed world, re-initialize at the
        # shrunken one, resume from the agreed checkpoint.
        t0 = time.monotonic()
        with goodput.scope("recovery_reshard_load"):
            self._stop_detector()
            self._teardown_world(state)
            if old_rank not in survivors:
                raise SMPEvicted(
                    f"process {old_rank} is not in the agreed survivor set "
                    f"{survivors}; exiting instead of training split-brain."
                )
            new_world = len(survivors)
            my_new_rank = survivors.index(old_rank)
            self._abandon_distributed()
            self._clear_runtime(new_world)
            if new_world > 1:
                if not coord:
                    raise SMPRecoveryError(
                        "multi-survivor recovery without an agreed "
                        "coordinator endpoint (rendezvous info incomplete)."
                    )
                self.initialize_distributed(coord, new_world, my_new_rank)
            self._reinit_framework(state, new_config)
            from smdistributed_modelparallel_tpu_torch.checkpoint import (
                resume_from_checkpoint,
            )
            resume_from_checkpoint(ckpt_path, tag=tag, partial=True,
                                   elastic=True)
            if step >= 0:
                state.step_count = int(step)
        reshard_s = time.monotonic() - t0
        flight_recorder.record_supervisor(
            "resume_done", detail=f"tag={tag} step={step} world={new_world}"
        )
        report = {
            "survivors": len(survivors), "survivor_ranks": survivors,
            "old_world": old_world, "rank": my_new_rank,
            "tag": tag, "step": int(step), "ckpt_path": ckpt_path,
            "failures": {int(k): v for k, v in failures.items()},
            "t_detect": t_detect,
            "t_resume_done": time.monotonic(),
            "phases": {
                "detect": detect_s,
                "rendezvous": rendezvous_s,
                "reshard_load": reshard_s,
            },
        }
        # MTTR closes at the first trained step (on_step_edge).
        self._await_first_step = report
        # The ledger sits in recovery_first_step until the resumed loop's
        # next ambient step/trace phase moves it (same closure point).
        goodput.enter("recovery_first_step")
        self.active = True
        logger.warning(
            "RECOVERY: world reformed %d -> %d (rank %d -> %d), resumed "
            "'%s' at step %d; training continues in-job.",
            old_world, new_world, old_rank, my_new_rank, tag, step,
        )
        return report

    # -- recovery phases ------------------------------------------------

    def _await_detection(self, detector, error):
        deadline = time.monotonic() + max(
            3 * detector.budget * detector.interval, 1.0
        )
        while True:
            failures = detector.failures()
            if failures:
                return failures
            if isinstance(error, SMPPeerLost):
                detector.force_dead(error.peer, why=str(error))
                error = None  # consumed; unknown peers fall to the deadline
                continue
            if time.monotonic() > deadline:
                return {}
            time.sleep(detector.interval / 2)

    def _rendezvous(self, bus, survivors, failures, grace):
        """Grace-bounded barrier + view exchange among the survivors over
        the old bus (per-pair TCP links — dead peers don't affect them).
        Survivors that die DURING the rendezvous (barrier, or between the
        barrier and their info landing) are dropped and the round retried;
        bounded rounds cover cascading deaths and view disagreement. A
        rank that finds ITSELF in the exchanged failed-union raises
        ``SMPEvicted`` (its peers are reforming without it)."""
        me = bus.rank

        def _solo():
            return [me], {me: {
                "rank": me, "failed": sorted(failures),
                "step": _state().step_count,
                "ckpt": latest_committed_checkpoint(self._ckpt_root),
            }}

        if len(survivors) <= 1:
            return _solo()
        timeout_ms = max(int(grace * 1000), 1000)
        max_rounds = len(survivors) + 1  # absorbs a full death cascade
        for _round in range(max_rounds):
            if len(survivors) <= 1:
                return _solo()

            def _drop(peer, why):
                self.detector_note_failure(peer)
                failures[peer] = DEAD
                logger.warning(
                    "rendezvous: dropping survivor %d (%s); retrying with "
                    "%s.", peer, why,
                    [s for s in survivors if s != peer],
                )

            # Drain stale RECOVERY_TX frames (an aborted earlier round's
            # exchange, a late eviction echo) so this round's recv pairs
            # with this round's sends.
            for p in survivors:
                if p != me:
                    try:
                        bus.drain_bytes(p, RECOVERY_TX)
                    except Exception:
                        pass
            lost = None
            try:
                bus.barrier(survivors, timeout_ms=timeout_ms)
            except SMPPeerLost as e:
                lost = e.peer
            except (OSError, SMPWatchdogTimeout) as e:
                # An armed watchdog can tighten the bus-level timeout and
                # raise its own type; either way the barrier did not
                # complete and no peer is attributable.
                raise SMPRecoveryError(
                    f"survivor rendezvous barrier failed: {e}"
                ) from e
            if lost is not None:
                if lost not in survivors:
                    raise SMPRecoveryError(
                        f"rendezvous barrier lost non-member {lost}."
                    )
                _drop(lost, "died at the rendezvous barrier")
                survivors = [s for s in survivors if s != lost]
                continue
            info = {
                "rank": me, "failed": sorted(failures),
                "step": _state().step_count,
                "ckpt": latest_committed_checkpoint(self._ckpt_root),
            }
            if me == min(survivors):
                info["coord"] = f"{self._local_ip()}:{_free_port()}"
            payload = json.dumps(info).encode()
            for p in survivors:
                if p != me:
                    bus.send_bytes(p, payload, RECOVERY_TX)
            infos = {me: info}
            for p in survivors:
                if p == me:
                    continue
                try:
                    infos[p] = json.loads(
                        bus.recv_bytes(p, RECOVERY_TX,
                                       timeout_ms=timeout_ms)
                    )
                except (SMPPeerLost, TimeoutError, OSError,
                        SMPWatchdogTimeout) as e:
                    lost = getattr(e, "peer", p)
                    break
            if lost is not None:
                _drop(lost, "died before its rendezvous info landed")
                survivors = [s for s in survivors if s != lost]
                continue
            union = set()
            for i in infos.values():
                union.update(int(f) for f in i.get("failed", ()))
            if me in union:
                raise SMPEvicted(
                    f"process {me} is in the survivors' failed-set union "
                    f"({sorted(union)}): the peers are reforming the "
                    "world without this rank; exiting instead of "
                    "training split-brain."
                )
            for f in union:
                failures.setdefault(f, DEAD)
            new_survivors = [s for s in survivors if s not in union]
            if new_survivors == survivors:
                return survivors, infos
            survivors = new_survivors
        raise SMPRecoveryError(
            f"survivor rendezvous did not converge within {max_rounds} "
            f"rounds (last view: {survivors})."
        )

    def detector_note_failure(self, peer):
        if self.detector is not None:
            self.detector.force_dead(peer, why="died during rendezvous")

    def _agree_checkpoint(self, infos, survivors):
        """The newest checkpoint committed on EVERY survivor. On the
        shared filesystems the checkpoint machinery assumes, every rank
        reports the same newest tag; under lag, the weakest report (the
        lowest step) is the safe agreement — anything newer is not proven
        visible everywhere."""
        reports = [infos[s].get("ckpt") for s in survivors if s in infos]
        if not reports or any(r is None for r in reports):
            raise SMPRecoveryError(
                "no committed checkpoint visible on every survivor under "
                f"'{self._ckpt_root}' — nothing consistent to recover "
                "from (save checkpoints, or lower the save interval)."
            )
        tag, step = min(
            ((r[0], int(r[1])) for r in reports), key=lambda r: (r[1], r[0])
        )
        flight_recorder.record_supervisor(
            "ckpt_agreed", detail=f"tag={tag} step={step}"
        )
        return tag, step

    def _notify_evicted(self, bus, failures, survivors):
        """Best-effort eviction notice to every failed-but-maybe-alive
        peer (a WEDGED rank can outlive its classification): it must exit
        (``SMPEvicted``) instead of recovering into a split brain."""
        for p, kind in failures.items():
            try:
                bus.send_raw(p, json.dumps({
                    "evict": True, "kind": kind,
                    "survivors": survivors,
                }).encode(), RECOVERY_TX)
            except Exception:
                pass

    def _teardown_world(self, state):
        """Drain pending saves, close the old bus (no relay: the dead peer
        would never answer) and drop what the failed world built: the model
        and optimizer (the caller rebuilds them), the step key and any
        staged checkpoint state."""
        from smdistributed_modelparallel_tpu_torch.checkpoint import wait_for_checkpoints

        try:
            wait_for_checkpoints()
        except Exception as e:
            logger.error("pending async save failed pre-recovery: %s", e)
        comm = state._comm
        if comm is not None:
            try:
                comm.shutdown()
            except Exception as e:
                logger.warning("bus shutdown during recovery failed: %s", e)
        state.model = None
        state.optimizer = None
        state.module_manager = None
        state.step_rng = None
        state.loaded_model_state = None
        state.loaded_optimizer_state = None

    def _abandon_distributed(self):
        """Drop the failed ``torch.distributed`` world without a collective
        on it. gloo's ``destroy_process_group`` only releases the groups'
        pairs and store (it returns at once with a dead peer, measured on
        the CPU), so the world is destroyed, not leaked."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        self._world = None
        os.environ.update(RANK="0", WORLD_SIZE="1")  # until a new world is started

    def _clear_runtime(self, new_world):
        """Forget the old world's groups; the port keeps no compiled
        program bound to a device set (the JAX package clears its backends
        and caches here)."""
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        state.groups = {}

    def _reinit_framework(self, state, new_config):
        """``smp.init`` again at the survivors' world, on this rank's device:
        ``new_config``, else the old config, else (when that does not fit
        the survivors) plain data parallelism with its microbatches."""
        from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
        from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

        device, world = state.device, self._world or (0, 1)
        if new_config is not None:
            cfg = new_config if isinstance(new_config, ModelParallelConfig) else ModelParallelConfig(new_config)
            state.initialize(cfg, device=device, world=world)
            return
        cfg = state.cfg
        try:
            state.initialize(cfg, device=device, world=world)
            return
        except SMPValidationError as e:
            logger.warning("previous config does not fit the %d survivor(s) (%s); falling back to plain data "
                           "parallelism.", world[1], e)
        state.initialize(ModelParallelConfig({"ddp": True, "microbatches": cfg.microbatches}), device=device,
                         world=world)

    # -- misc -----------------------------------------------------------

    @property
    def _ckpt_root(self):
        from smdistributed_modelparallel_tpu_torch.resilience.preemption import (
            EMERGENCY_PATH_ENV,
        )

        return self._recover_ckpt_path or os.environ.get(EMERGENCY_PATH_ENV)

    @staticmethod
    def _local_ip():
        from smdistributed_modelparallel_tpu_torch.backend.collectives import _local_ip

        return _local_ip()

    def _abort(self, reason):
        """Unrecoverable: dump the detector state + flight ring before the
        typed raise so the post-mortem has the whole story."""
        snap = self.detector.snapshot() if self.detector else None
        logger.error(
            "UNRECOVERABLE recovery abort: %s\ndetector state: %s",
            reason, json.dumps(snap, default=str),
        )
        flight_recorder.record_supervisor("abort", detail=reason[:200])
        try:
            watchdog.dump(f"supervisor: unrecoverable recovery abort "
                          f"({reason})")
        except Exception:
            pass


def _collective_timeout():
    """``SMP_COLLECTIVE_TIMEOUT`` in seconds, or None (unset, not a number
    or not positive), as the JAX package's host collectives read it."""
    raw = os.environ.get("SMP_COLLECTIVE_TIMEOUT", "")
    if not raw:
        return None
    try:
        t = float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric SMP_COLLECTIVE_TIMEOUT=%r.", raw)
        return None
    return t if t > 0 else None


def _state():
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    return state


def latest_committed_checkpoint(root):
    """(tag, step) of the newest COMMITTED partial checkpoint under
    ``root``, or None. Step comes from the saved config snapshot's
    ``step_count`` (stamped by ``save_checkpoint``), falling back to a
    ``step_<N>`` tag parse, then -1. "Newest" prefers the ``newest``
    pointer when it names a committed dir, else the highest step, else
    mtime."""
    import pickle
    import re

    if not root or not os.path.isdir(root):
        return None

    def _step_of(ckpt_dir, tag):
        cfg_path = os.path.join(ckpt_dir, "smp_config.pt")
        try:
            with open(cfg_path, "rb") as fh:
                snap = pickle.load(fh)
            if isinstance(snap, dict) and "step_count" in snap:
                return int(snap["step_count"])
        except Exception:
            pass
        m = re.search(r"step_?(\d+)", tag)
        return int(m.group(1)) if m else -1

    committed = []
    for d in sorted(os.listdir(root)):
        if not d.endswith("_partial"):
            continue
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            continue
        if not os.path.exists(os.path.join(full, ".committed")):
            continue
        tag = d[: -len("_partial")]
        try:
            mtime = os.path.getmtime(full)
        except OSError:
            mtime = 0.0
        committed.append((tag, _step_of(full, tag), mtime))
    if not committed:
        return None
    newest_path = os.path.join(root, "newest")
    if os.path.exists(newest_path):
        try:
            with open(newest_path) as fh:
                newest = fh.read().strip()
            for tag, step, _ in committed:
                if tag == newest:
                    return (tag, step)
        except OSError:
            pass
    tag, step, _ = max(committed, key=lambda c: (c[1], c[2]))
    return (tag, step)


supervisor = Supervisor()


def classify_failed(bus, peers, kinds=(DEAD, WEDGED)):
    """Classify which of ``peers`` have failed, as ``{peer: kind}``.

    Combines the heartbeat detector's verdicts (when the supervisor is
    on) with the bus's own link-death signal — ``peer_down`` catches a
    closed socket before the miss budget expires, and is the only
    signal when ``SMP_SUPERVISOR=off``. Shared by replica failover
    (serving/replica.py) and fleet aggregator election (utils/fleet.py)
    so both planes agree on who is alive.
    """
    peers = set(peers)
    failed = {}
    detector = supervisor.detector
    if detector is not None:
        failed.update(detector.failures(kinds=kinds))
    if bus is not None and DEAD in kinds:
        for p in peers:
            if p not in failed and bus.peer_down(p):
                failed[p] = DEAD
    return {p: k for p, k in failed.items() if p in peers}
