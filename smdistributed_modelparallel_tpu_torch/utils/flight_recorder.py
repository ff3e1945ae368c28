"""Always-on flight recorder: a bounded ring buffer of structured events
(``smp.flight_recorder``).

Counterpart of ``smdistributed_modelparallel_tpu/utils/flight_recorder.py``
with the same event kinds, fields and JSONL format. At world size 1 the step
and compile events fire (``record_step`` at the step edges, ``record_compile``
for each kernel build, ``ops/_build.py``), with the serving spans, goodput
transitions and phases; the per-group collective sequence numbers wait for
the collectives slice.

Parity target: the reference's per-action timeline (``smp_timeline_*``
around every server action, SURVEY §2.1 N5) answers "what was this rank
doing" — but only when a timeline file was requested up front. Production
post-mortems need that answer for runs that were NOT being traced: when a
64-chip job wedges or crashes, the operator wants the last ~N things each
rank did (which collective, which schedule slot, which compile phase)
without having paid tracing overhead for the hours before.

This module is that black box. Design constraints, in priority order:

- **always on at near-zero cost**: recording is one ``time.perf_counter``
  call plus one bounded-``deque`` append of a plain tuple. No dict build,
  no string formatting, no lock on the hot path (``deque.append`` is
  atomic under CPython; the only lock guards the per-group collective
  sequence counters). Formatting happens once, at dump time.
- **bounded**: the ring holds ``SMP_FLIGHT_RECORDER_SIZE`` events
  (default 1024; ``0`` disables recording entirely — the record methods
  return before touching the clock).
- **diagnosable desyncs**: every collective event carries a per-group
  monotonic sequence number. Two ranks' rings can be diffed seq-by-seq:
  if rank 0's seq 17 on WORLD is a broadcast and rank 3's is a barrier,
  the collective streams diverged at 17 — the classic silent-hang cause
  the reference could only show as a stack dump.
- **clock-anchored**: the ring records monotonic microseconds since an
  anchor captured at construction together with the wall-clock time of
  that anchor, so ``scripts/trace_fuse.py`` can align rings (and
  timelines) from different ranks on one axis, refined by barrier sync
  marks.

Dump paths: ``dump()`` writes JSONL (one meta line, then one line per
event, oldest first) to ``SMP_FLIGHT_RECORDER_PATH`` (rank-qualified via
the telemetry registry's ``_rank_path``), automatically at exit; the
watchdog embeds ``snapshot()`` in every stall dump (see
``utils/telemetry.py``); ``smp.flight_recorder`` is the live handle.

Import-hygiene contract: stdlib + the package logger/telemetry only —
importing this module must never initialize an accelerator backend.
"""

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

logger = get_logger()

FLIGHT_RECORDER_PATH_ENV = "SMP_FLIGHT_RECORDER_PATH"
FLIGHT_RECORDER_SIZE_ENV = "SMP_FLIGHT_RECORDER_SIZE"
DEFAULT_SIZE = 1024

# Event kinds (kept short: they are stored per event).
COLLECTIVE = "collective"
SYNC = "sync"
WAIT = "wait"
SLOT = "slot"
PHASE = "phase"
STEP = "step"
COMPILE = "compile"
WATCHDOG = "watchdog"
HEALTH = "health"
PREEMPT = "preempt"
CHAOS = "chaos"
SUPERVISOR = "supervisor"
SERVE = "serve"
FLEET = "fleet"
GOODPUT = "goodput"
PERF = "perf"
CONTROLLER = "controller"

# Field names per kind, applied at dump time (the ring stores bare
# tuples). Keeping the schema here — not at the record sites — is what
# keeps recording allocation-free beyond the tuple itself.
_FIELDS = {
    COLLECTIVE: ("op", "group", "nbytes", "group_size", "seq"),
    SYNC: ("name", "group", "seq", "wall_us"),
    WAIT: ("what", "peer", "tx", "outcome", "elapsed_us"),
    SLOT: ("schedule", "tick", "stage", "direction", "microbatch", "chunk",
           "pass"),
    PHASE: ("phase",),
    STEP: ("event", "step"),
    COMPILE: ("event", "name", "elapsed_us", "fingerprint"),
    WATCHDOG: ("reason",),
    HEALTH: ("event", "tag", "step", "value", "microbatch"),
    PREEMPT: ("event", "step", "detail"),
    CHAOS: ("fault", "detail"),
    SUPERVISOR: ("event", "peer", "detail", "wall_us"),
    SERVE: ("event", "rid", "trace", "slot", "pos", "detail"),
    FLEET: ("event", "rank", "detail", "wall_us"),
    GOODPUT: ("state", "prev", "elapsed_us"),
    PERF: ("event", "source", "detail", "wall_us"),
    CONTROLLER: ("event", "detail", "wall_us"),
}


def _env_size():
    raw = os.environ.get(FLIGHT_RECORDER_SIZE_ENV, "")
    if not raw:
        return DEFAULT_SIZE
    try:
        n = int(raw)
    except ValueError:
        logger.warning(
            "invalid %s=%r (want an integer); using default %d.",
            FLIGHT_RECORDER_SIZE_ENV, raw, DEFAULT_SIZE,
        )
        return DEFAULT_SIZE
    return max(n, 0)


class FlightRecorder:
    """Bounded ring of (id, t_us, kind, fields...) event tuples."""

    def __init__(self, size=None):
        size = _env_size() if size is None else max(int(size), 0)
        self.size = size
        self.enabled = size > 0
        self._ring = deque(maxlen=size) if size > 0 else None
        self._ids = itertools.count()
        self._seq_lock = threading.Lock()
        self._seq = {}
        # Wall-clock anchor: t=0 of the monotonic event clock. Captured
        # back-to-back so (anchor_unix_us + t_us) approximates the wall
        # time of any event; trace_fuse refines the residual per-rank
        # skew with barrier sync marks.
        self.anchor_unix_us = int(time.time() * 1e6)
        self._t0 = time.perf_counter()

    # -- hot path -------------------------------------------------------

    def _now_us(self):
        return (time.perf_counter() - self._t0) * 1e6

    def record(self, kind, *fields):
        """Append one event. The disabled path is a single attribute test."""
        if not self.enabled:
            return
        self._ring.append((next(self._ids), self._now_us(), kind) + fields)

    def next_seq(self, group):
        """Per-group monotonic collective sequence number. Every rank that
        executes the same collective stream gets the same numbers, so a
        cross-rank ring diff pinpoints the first diverging collective."""
        with self._seq_lock:
            seq = self._seq.get(group, 0)
            self._seq[group] = seq + 1
            return seq

    # -- typed recorders (keep the tuple layouts in _FIELDS) ------------

    def record_collective(self, op, group, nbytes, group_size,
                          sequenced=True):
        """``sequenced=False`` records the event WITHOUT consuming the
        group's sequence counter (seq -1). Point-to-point ops must use it:
        send/recv streams are rank-local by nature, and letting them bump
        the group counter would make healthy ranks' sequence streams
        diverge — false positives in the cross-rank desync diff, and
        mismatched barrier seqs that break sync-mark clock alignment."""
        if not self.enabled:
            return None
        seq = self.next_seq(group) if sequenced else -1
        self.record(COLLECTIVE, op, group, int(nbytes), int(group_size), seq)
        return seq

    def record_sync(self, name, group, seq):
        """A barrier-exit sync mark: all participating ranks record this
        within network-jitter of each other, carrying their own wall
        clock — the cross-rank clock-alignment signal."""
        if not self.enabled:
            return
        self.record(SYNC, name, group, seq, int(time.time() * 1e6))

    def record_wait(self, what, peer, tx, outcome, elapsed_s):
        if not self.enabled:
            return
        self.record(WAIT, what, int(peer), int(tx), outcome,
                    int(elapsed_s * 1e6))

    def record_slot(self, schedule, tick, stage, direction, microbatch,
                    chunk=None, pipe_pass=None):
        """``chunk`` is the virtual-pipeline chunk coordinate (interleaved
        schedules only); plain schedules omit it and their events keep the
        pre-chunk field layout. ``pipe_pass`` (dumped as ``pass``) is the
        schedule pass coordinate of split-backward schedules — "F", "B"
        (input-grad) or "W" (weight-grad); it requires ``chunk`` (the
        zero-bubble executor is always chunk-generalized)."""
        if chunk is None:
            self.record(SLOT, schedule, int(tick), int(stage), direction,
                        int(microbatch))
        elif pipe_pass is None:
            self.record(SLOT, schedule, int(tick), int(stage), direction,
                        int(microbatch), int(chunk))
        else:
            self.record(SLOT, schedule, int(tick), int(stage), direction,
                        int(microbatch), int(chunk), str(pipe_pass))

    def record_schedule(self, schedule, slots, cap=512):
        """Record a static pipeline schedule's busy slots (once, at
        build/trace time — the compiled program replays it every step).
        ``slots``: iterable of (tick, stage, direction, microbatch),
        (tick, stage, direction, microbatch, chunk) for interleaved
        virtual-stage schedules, or (tick, stage, direction, microbatch,
        chunk, pass) for zero-bubble split-backward schedules. Bounded to
        ``cap`` events so a huge schedule cannot evict the whole
        collective/wait history from the ring; truncation leaves an
        explicit marker."""
        if not self.enabled:
            return
        n = 0
        for slot in slots:
            if n >= cap:
                self.record(SLOT, schedule, -1, -1, "truncated", -1)
                break
            self.record_slot(schedule, *slot)
            n += 1

    def record_phase(self, phase):
        self.record(PHASE, phase)

    def record_step(self, event, step):
        self.record(STEP, event, int(step))

    def record_compile(self, event, name, elapsed_s=0.0, fingerprint=None):
        """``fingerprint`` ties a compile event to its program's X-ray
        fingerprint (utils/hlo_audit.py); events recorded without one
        keep the shorter pre-fingerprint tuple layout."""
        if fingerprint is None:
            self.record(COMPILE, event, name, int(elapsed_s * 1e6))
        else:
            self.record(COMPILE, event, name, int(elapsed_s * 1e6),
                        str(fingerprint))

    def record_watchdog(self, reason):
        self.record(WATCHDOG, reason)

    def record_health(self, event, tag, step=-1, value=0.0, microbatch=-1):
        """Training-health events (utils/health.py): sentinel trips, fault
        attributions, loss-scale overflow/growth, OOM post-mortems."""
        if not self.enabled:
            return
        self.record(HEALTH, event, str(tag), int(step), float(value),
                    int(microbatch))

    def record_preempt(self, event, step=-1, detail=""):
        """Resilience events (resilience/): preemption request/rendezvous/
        emergency-save edges and elastic-resume markers."""
        if not self.enabled:
            return
        self.record(PREEMPT, event, int(step), str(detail))

    def record_chaos(self, fault, detail=""):
        """An injected fault (resilience/chaos.py) — so post-mortem rings
        distinguish synthetic failures from real ones."""
        if not self.enabled:
            return
        self.record(CHAOS, str(fault), str(detail))

    def record_supervisor(self, event, peer=-1, detail=""):
        """Failure-detector / recovery-protocol events
        (resilience/supervisor.py): detections by kind, the recovery
        phase edges (rendezvous / reinit / resume / first step), aborts.
        Carries a wall-clock stamp so ``resilience_probe.py --recovery``
        can compute per-phase MTTR across dumps without ring-anchor
        arithmetic."""
        if not self.enabled:
            return
        self.record(SUPERVISOR, str(event), int(peer), str(detail),
                    int(time.time() * 1e6))

    def record_fleet(self, event, rank=-1, detail=""):
        """Fleet metrics-plane events (utils/fleet.py): aggregator
        (re-)election edges and detector transitions — straggler /
        stale_feed / kv_imbalance firing or clearing. ``rank`` is the
        subject replica (the new aggregator, the straggler), not the
        recording rank. Wall-stamped like supervisor events so
        ``trace_fuse.py`` can line detector fire-times up against the
        per-request serve spans."""
        if not self.enabled:
            return
        self.record(FLEET, str(event), int(rank), str(detail),
                    int(time.time() * 1e6))

    def record_serve(self, event, rid, trace=None, slot=-1, pos=-1,
                     detail=""):
        """Per-request serving span edges (serving/engine.py): queued /
        admitted / readmitted / prefill_chunk / first_token / finished.
        ``trace`` is the request's trace id (defaulting to the request
        id; preserved across failover re-admission via the mirror log,
        so both replicas' rings carry the same trace key) and ``slot``
        the decode-slot index — the lane ``scripts/trace_fuse.py`` draws
        the request's spans on."""
        if not self.enabled:
            return
        self.record(SERVE, str(event), str(rid), str(trace or rid),
                    int(slot), int(pos), str(detail))

    def record_goodput(self, state, prev, elapsed_s=0.0):
        """A goodput-ledger attribution transition (utils/goodput.py):
        the process left ``prev`` (after ``elapsed_s`` attributed to it)
        and entered ``state``. The stream ``trace_fuse.py`` renders as
        the per-rank badput track."""
        if not self.enabled:
            return
        self.record(GOODPUT, str(state), str(prev), int(elapsed_s * 1e6))

    def record_perf(self, event, source, detail=""):
        """Perf-regression sentinel and auto-forensics events
        (utils/goodput.py): ``regression``/``regression_clear`` edges
        (source = step_time | itl), ``goodput_min`` floor breaches, and
        ``forensics`` bundle captures. Wall-stamped like supervisor
        events so post-mortems line them up across ranks."""
        if not self.enabled:
            return
        self.record(PERF, str(event), str(source), str(detail),
                    int(time.time() * 1e6))

    def record_controller(self, event, detail=""):
        """Serving control-plane events (serving/controller.py): scale
        event edges (``scale_up`` / ``scale_down`` with phase timings),
        weight adoptions, canary verdicts, drain begin/end. Wall-stamped
        like supervisor events so ``scripts/trace_fuse.py`` and
        ``slo_report --controller`` can line a scale event up against
        the request spans that triggered it."""
        if not self.enabled:
            return
        self.record(CONTROLLER, str(event), str(detail),
                    int(time.time() * 1e6))

    def last_seq(self, group):
        """The group's current collective sequence number (the seq the
        NEXT sequenced collective would get), without consuming it: a
        typed collective-timeout error carries it as the coordinate where
        this rank's stream stopped."""
        with self._seq_lock:
            return self._seq.get(group, 0)

    # -- export ---------------------------------------------------------

    def _meta(self):
        with self._seq_lock:
            seqs = dict(self._seq)
        return {
            "kind": "meta",
            "pid": os.getpid(),
            "rank": telemetry.process_index,
            "world": telemetry.process_count,
            "size": self.size,
            "anchor_unix_us": self.anchor_unix_us,
            "collective_seq": seqs,
            "dumped_unix_us": int(time.time() * 1e6),
        }

    def snapshot(self, last=None):
        """List of event dicts, oldest first (formatting happens here, not
        at record time). ``last`` keeps only the most recent N."""
        if self._ring is None:
            return []
        events = list(self._ring)
        if last is not None:
            # last=0 must mean "no events", not the [-0:] whole-list slice.
            events = events[-last:] if last > 0 else []
        out = []
        for ev in events:
            eid, t_us, kind = ev[0], ev[1], ev[2]
            d = {"id": eid, "ts_us": round(t_us, 1), "kind": kind}
            for name, value in zip(_FIELDS.get(kind, ()), ev[3:]):
                d[name] = value
            out.append(d)
        return out

    def __len__(self):
        return 0 if self._ring is None else len(self._ring)

    def clear(self):
        """Testing hook: drop events and sequence counters."""
        if self._ring is not None:
            self._ring.clear()
        with self._seq_lock:
            self._seq.clear()

    def dump(self, path=None):
        """Write the ring as JSONL (meta line first) atomically. Explicit
        ``path`` wins; otherwise ``SMP_FLIGHT_RECORDER_PATH`` (no-op when
        neither is set). Rank-qualified under multi-process like the
        telemetry dump. Returns the path written, or None."""
        path = path or os.environ.get(FLIGHT_RECORDER_PATH_ENV)
        if not path:
            return None
        path = telemetry._rank_path(path)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(self._meta()) + "\n")
                for d in self.snapshot():
                    f.write(json.dumps(d) + "\n")
            os.replace(tmp, path)
            return path
        except OSError as e:
            logger.warning("flight-recorder dump to %s failed: %s", path, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None


# ----------------------------------------------------------------------
# Singleton + hooks
# ----------------------------------------------------------------------

flight_recorder = FlightRecorder()

# Phase transitions flow into the ring without telemetry importing this
# module (utils/telemetry.py stays leaf; see its _phase_listener seam).
# Resolved through the module attribute at CALL time — not a bound method
# of the import-time instance — so tests (or anything else) that swap
# `flight_recorder` keep phases flowing to the live ring, same as
# telemetry's _flight() seam does for collectives.
def _phase_to_ring(phase):
    flight_recorder.record_phase(phase)


telemetry._phase_listener = _phase_to_ring


def _atexit_dump():  # pragma: no cover - exercised via subprocess test
    try:
        # The crash path too: atexit runs after sys.excepthook, so the
        # ring's tail shows what the process did right before dying. An
        # empty ring must not clobber the dump smp.shutdown already wrote
        # (state.reset clears the ring after shutdown dumps it).
        if len(flight_recorder):
            flight_recorder.dump()
    except Exception:
        pass


atexit.register(_atexit_dump)
