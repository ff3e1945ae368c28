"""Serving control plane (``smp.serving.controller``): SLO-driven
autoscaling, canaried live weight updates and the drain protocol.

Counterpart of ``smdistributed_modelparallel_tpu/serving/controller.py``,
with its policy, feed records, gauges and environment variables. Armed by
``SMP_AUTOSCALE`` (1/on/true/yes): unset, ``ServingController.from_env``
returns None and nothing is constructed. Armed, the controller evaluates the
fleet plane's aggregated windows (or a caller's ``window_source``) against
the ``SMP_SLO`` targets.

``AutoscalePolicy`` is a pure decision function with an injectable clock:
**hysteresis** (``SMP_AUTOSCALE_HYSTERESIS`` consecutive breached windows
fire "up"; as many comfortable ones, SLO met, queue empty and every
upper-bound metric under half its limit, fire "down"), **cooldown**
(``SMP_AUTOSCALE_COOLDOWN`` seconds without another event) and **clamps**
(``SMP_AUTOSCALE_MIN``/``SMP_AUTOSCALE_MAX``).

Scale-up activates a standby replica (a ``RemoteReplicaHandle``'s
``activate`` against a parked ``ReplicaServer``, or a local factory); the
event's phases are ``trigger`` (breach start -> decision), ``rendezvous``,
``warm_start`` (the engine's construction) and ``first_token``, and its
``warm`` report counts the activation's compile events by source (the
port's: kernel libraries built fresh by ``nvcc`` or loaded from disk,
``serving/router.py``). Scale-down is the DRAIN protocol: the victim stops
admitting, finishes its in-flight streams (moving them would break their key
schedules) and hands back its queued-never-admitted requests as restartable
records, which the router re-dispatches: no token dropped or duplicated.

Live weight updates: ``adopt_params`` copies new weights into the engine's
own tensors between ticks (nothing recompiles). ``start_canary`` replays
pinned prompts on the canary replica against the old and the new weights
(token parity, bit for bit, is the oracle), then shifts
``SMP_CANARY_FRACTION`` of traffic to the new version and watches
``SMP_CANARY_WINDOWS`` SLO windows; a mismatch or a breached window rolls
back (old weights restored, split dropped, ``smp_canary_rollback_total``,
one forensics bundle), survival promotes the version on every replica.

Every decision lands in the ``smp_controller_*`` / ``smp_autoscale_*`` /
``smp_canary_*`` gauges, the flight recorder's ``controller`` events and the
``SMP_CONTROLLER_PATH`` JSONL feed that ``scripts/slo_report.py
--controller`` reads. ``smp.shutdown`` closes every armed controller's open
events (``shutdown_all``) and ``smp.reset`` drops them (``reset_all``).
"""

import dataclasses
import json
import os
import time

from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.serving.engine import (
    serve_request_from_record,
)
from smdistributed_modelparallel_tpu_torch.serving.router import (
    LocalReplicaHandle,
    RequestRouter,
)
from smdistributed_modelparallel_tpu_torch.utils import exec_cache
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPValidationError,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    record_canary,
    record_controller_replicas,
    record_drain_stragglers,
    record_scale_event,
)
from smdistributed_modelparallel_tpu_torch.utils.timeseries import (
    evaluate_slo,
    parse_slo,
)

logger = get_logger()

AUTOSCALE_ENV = "SMP_AUTOSCALE"
COOLDOWN_ENV = "SMP_AUTOSCALE_COOLDOWN"
MIN_ENV = "SMP_AUTOSCALE_MIN"
MAX_ENV = "SMP_AUTOSCALE_MAX"
HYSTERESIS_ENV = "SMP_AUTOSCALE_HYSTERESIS"
PATH_ENV = "SMP_CONTROLLER_PATH"
CANARY_FRACTION_ENV = "SMP_CANARY_FRACTION"
CANARY_WINDOWS_ENV = "SMP_CANARY_WINDOWS"

_TRUTHY = ("1", "on", "true", "yes")

#: Armed controllers, for core.shutdown / state.reset (lazy hooks — the
#: backend must not import this module unless something constructed one).
_ACTIVE = []


def _env_float(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using default %g.",
                       name, raw, default)
        return default


def _env_int(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using default %d.",
                       name, raw, default)
        return default


def _trigger_forensics(reason, detail=""):
    try:
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        goodput.trigger_forensics(reason, detail=detail)
    except Exception:
        logger.warning("forensics trigger (%s) failed", reason,
                       exc_info=True)


def shutdown_all():
    """core.shutdown hook: close pending scale events and unregister
    every armed controller (before the fleet plane stops — the last
    events still want the bus)."""
    for c in list(_ACTIVE):
        try:
            c.stop()
        except Exception:
            logger.warning("controller shutdown failed", exc_info=True)


def reset_all():
    """state.reset hook: drop registrations without running teardown
    (tests re-init from scratch)."""
    del _ACTIVE[:]


class AutoscalePolicy:
    """Pure decision function: windows in, "up"/"down"/None out.

    Deliberately free of I/O and injectable-clocked so the policy units
    run on a fake clock — hysteresis in both directions, the cooldown
    latch, min/max clamps and flap suppression are all table-driven
    tests, not sleeps."""

    def __init__(self, slo=None, *, min_replicas=1, max_replicas=4,
                 cooldown_s=30.0, hysteresis=2, scale_down_ratio=0.5,
                 clock=time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise SMPValidationError(
                f"autoscale clamps must satisfy 1 <= min <= max, got "
                f"min={min_replicas} max={max_replicas}."
            )
        if hysteresis < 1:
            raise SMPValidationError(
                f"autoscale hysteresis must be >= 1, got {hysteresis}."
            )
        self.slo = dict(slo or {})
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.hysteresis = int(hysteresis)
        self.scale_down_ratio = float(scale_down_ratio)
        self._clock = clock
        self._breach = 0
        self._comfort = 0
        self._last_event = None
        #: wall of the tick that STARTED the current streak — the scale
        #: event's ``trigger`` phase (how long the breach went unanswered).
        self.streak_started = None
        self.fired_streak_started = None
        self.last_verdict = {"ok": True, "violations": {}}

    def _headroom(self, window):
        """True when every upper-bound SLO metric present in the window
        sits under ``scale_down_ratio`` of its threshold — merely
        meeting the SLO is not evidence a replica is surplus."""
        for key, limit in self.slo.items():
            if key.endswith("_min") or key == "queue_depth":
                continue
            value = window.get(key)
            if value is not None and value > limit * self.scale_down_ratio:
                return False
        return True

    def observe(self, window, live, now=None):
        """Feed one aggregated window; returns "up", "down" or None.
        ``live`` is the current live-replica count (for the clamps)."""
        now = self._clock() if now is None else now
        verdict = (
            evaluate_slo(self.slo, window)
            if self.slo else {"ok": True, "violations": {}}
        )
        self.last_verdict = verdict
        breached = not verdict["ok"]
        comfortable = (
            not breached
            and float(window.get("queue_depth") or 0) == 0.0
            and self._headroom(window)
        )
        if breached:
            if self._breach == 0:
                self.streak_started = now
            self._breach += 1
            self._comfort = 0
        elif comfortable:
            if self._comfort == 0:
                self.streak_started = now
            self._comfort += 1
            self._breach = 0
        else:
            self._breach = 0
            self._comfort = 0
            self.streak_started = None
        in_cooldown = (
            self._last_event is not None
            and now - self._last_event < self.cooldown_s
        )
        if in_cooldown:
            return None
        if breached and self._breach >= self.hysteresis:
            if live >= self.max_replicas:
                return None   # clamped: keep the streak, re-ask next tick
            self._fire(now)
            return "up"
        if comfortable and self._comfort >= self.hysteresis:
            if live <= self.min_replicas:
                return None
            self._fire(now)
            return "down"
        return None

    def _fire(self, now):
        self._last_event = now
        self._breach = 0
        self._comfort = 0
        # Keep the fired streak's start readable: the scale event's
        # ``trigger`` phase is how long the breach went unanswered.
        self.fired_streak_started = self.streak_started
        self.streak_started = None


class ServingController:
    """The armed control loop: owns a ``RequestRouter``, a standby
    list, the scale-event ledger and the canary state machine."""

    def __init__(self, router=None, policy=None, *, window_source=None,
                 path=None, canary_fraction=0.25, canary_windows=2,
                 clock=time.monotonic):
        self.router = router if router is not None else RequestRouter()
        self.policy = policy if policy is not None else AutoscalePolicy()
        self._window_source = window_source
        self.path = path
        self.canary_fraction = float(canary_fraction)
        self.canary_windows = int(canary_windows)
        self._clock = clock
        self._standby = []          # (name, activate_fn) in preference order
        self._order = []            # activation order, scale-down victims
        self._pending = []          # scale-up events awaiting first token
        self._retired = {}          # results of drained/detached replicas
        self._seen_seq = None
        self.scale_events = []
        self.canary = None
        self.rollbacks = 0
        self.promotions = 0
        _ACTIVE.append(self)

    # -- construction ---------------------------------------------------

    @classmethod
    def from_env(cls, router=None, window_source=None,
                 clock=time.monotonic):
        """The arming gate: ``SMP_AUTOSCALE`` unset/falsy returns None
        and constructs NOTHING."""
        if os.environ.get(AUTOSCALE_ENV, "").lower() not in _TRUTHY:
            return None
        policy = AutoscalePolicy(
            parse_slo(os.environ.get("SMP_SLO", "")),
            min_replicas=_env_int(MIN_ENV, 1),
            max_replicas=_env_int(MAX_ENV, 4),
            cooldown_s=_env_float(COOLDOWN_ENV, 30.0),
            hysteresis=_env_int(HYSTERESIS_ENV, 2),
            clock=clock,
        )
        return cls(
            router=router,
            policy=policy,
            window_source=window_source,
            path=os.environ.get(PATH_ENV) or None,
            canary_fraction=_env_float(CANARY_FRACTION_ENV, 0.25),
            canary_windows=_env_int(CANARY_WINDOWS_ENV, 2),
            clock=clock,
        )

    # -- membership -----------------------------------------------------

    def register_live(self, handle):
        """Attach an already-running replica (the deployment's initial
        set)."""
        self.router.attach(handle)
        self._order.append(handle.name)
        record_controller_replicas(len(self.router.live_handles()))
        return handle

    def add_standby(self, name, activate_fn):
        """Register scale-up capacity: ``activate_fn()`` must return a
        live router handle (building the engine is the warm start; a
        ``RemoteReplicaHandle`` wraps the rendezvous too)."""
        self._standby.append((str(name), activate_fn))

    @property
    def replicas(self):
        return len(self.router.live_handles())

    def results(self):
        merged = dict(self._retired)
        merged.update(self.router.results())
        return merged

    # -- JSONL feed -----------------------------------------------------

    def _append_jsonl(self, rec):
        if not self.path:
            return
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            logger.warning("controller feed write to %s failed",
                           self.path, exc_info=True)

    # -- control loop ---------------------------------------------------

    def _window(self):
        if self._window_source is not None:
            return self._window_source()
        from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet

        return fleet.last_window()

    def tick(self):
        """One control-loop evaluation: close pending first-token
        phases, then feed the newest UNSEEN aggregated window to the
        canary gate (when one is live) or the autoscale policy.
        Returns "up"/"down" when a scale event fired, else None."""
        self._close_pending()
        window = self._window()
        if window is None:
            return None
        seq = window.get("seq")
        if seq is not None and seq == self._seen_seq:
            return None
        self._seen_seq = seq
        if self.canary is not None:
            self._canary_window(window)
            return None
        decision = self.policy.observe(window, live=self.replicas)
        if decision == "up":
            return "up" if self.scale_up(window=window) else None
        if decision == "down":
            return "down" if self.scale_down(window=window) else None
        return None

    def _reason(self):
        bad = self.policy.last_verdict.get("violations", {})
        return "slo:" + ",".join(sorted(bad)) if bad else "headroom"

    # -- scale events ---------------------------------------------------

    def scale_up(self, reason=None, window=None):
        """Activate the next standby replica. The event's MTTR phases
        mirror a recovery: trigger (breach start -> now), rendezvous,
        warm_start (engine construction, exec-cache hot), first_token
        (closed lazily — the first request the new replica finishes)."""
        if not self._standby:
            logger.warning(
                "[controller] scale-up wanted but no standby replica is "
                "registered; staying at %d.", self.replicas,
            )
            return None
        now = self._clock()
        trigger_s = (
            max(now - self.policy.fired_streak_started, 0.0)
            if getattr(self.policy, "fired_streak_started", None)
            is not None else 0.0
        )
        name, activate_fn = self._standby.pop(0)
        t0 = self._clock()
        mark = exec_cache.compile_event_mark()
        handle = activate_fn()
        total = self._clock() - t0
        warm_s = getattr(handle, "activate_seconds", None)
        if warm_s is None:
            warm_s, rendezvous_s = total, 0.0
        else:
            rendezvous_s = max(total - warm_s, 0.0)
        # Warm-start evidence: a remote handle ships the peer's
        # compile-source counts in its ready frame; a local activation
        # compiled in-process, so read this process's event ledger.
        warm = dict(getattr(handle, "warm", None) or {})
        if not warm:
            for ev in exec_cache.compile_events_since(mark):
                src = ev.get("source", "?")
                warm[src] = warm.get(src, 0) + 1
        handle.live = True
        self.router.attach(handle)
        self._order.append(handle.name)
        event = {
            "kind": "scale_event",
            "direction": "up",
            "seq": len(self.scale_events) + 1,
            "t_wall": time.time(),
            "reason": reason or self._reason(),
            "replicas": self.replicas,
            "replica": handle.name,
            "warm": warm,
            "window_seq": window.get("seq") if window else None,
            "phases": {
                "trigger": trigger_s,
                "rendezvous": rendezvous_s,
                "warm_start": warm_s,
            },
        }
        self.scale_events.append(event)
        self._pending.append({
            "event": event,
            "handle": handle,
            "t0": self._clock(),
            "baseline": len(handle.results()),
        })
        logger.warning(
            "[controller] SCALE UP -> %d replicas (%s): trigger %.2fs, "
            "rendezvous %.2fs, warm start %.2fs.",
            self.replicas, event["reason"], trigger_s, rendezvous_s, warm_s,
        )
        return handle

    def _close_pending(self, force=False):
        for pend in list(self._pending):
            served = len(pend["handle"].results()) > pend["baseline"]
            if not served and not force:
                continue
            self._pending.remove(pend)
            first_token = self._clock() - pend["t0"] if served else 0.0
            event = pend["event"]
            event["phases"]["first_token"] = first_token
            self._finalize(event)

    def _finalize(self, event):
        event["seconds"] = sum(event["phases"].values())
        record_scale_event(
            event["direction"], event["seconds"],
            phases=event["phases"], replicas=event["replicas"],
        )
        self._append_jsonl(event)
        chaos.on_scale_event(event["seq"])

    def scale_down(self, reason=None, window=None):
        """Drain-protocol shrink: the last-activated live replica stops
        admitting, finishes its in-flight streams, and its queued
        stragglers are re-dispatched to the survivors as restartable
        mirror records. Zero dropped or duplicated tokens."""
        live = [
            self.router.handles[n] for n in self._order
            if n in self.router.handles and self.router.handles[n].live
        ]
        if len(live) <= max(self.policy.min_replicas, 1):
            return None
        self._close_pending(force=True)   # never shrink with an open event
        victim = live[-1]
        t0 = self._clock()
        stragglers = victim.drain()
        drain_s = self._clock() - t0
        self._retired.update(victim.results())
        self.router.detach(victim.name)
        self._order.remove(victim.name)
        if hasattr(victim, "deactivate"):
            victim.deactivate()
        t1 = self._clock()
        for rec in stragglers:
            self.router.dispatch(serve_request_from_record(rec))
        record_drain_stragglers(len(stragglers))
        reroute_s = self._clock() - t1
        event = {
            "kind": "scale_event",
            "direction": "down",
            "seq": len(self.scale_events) + 1,
            "t_wall": time.time(),
            "reason": reason or "sustained_headroom",
            "replicas": self.replicas,
            "replica": victim.name,
            "stragglers": len(stragglers),
            "window_seq": window.get("seq") if window else None,
            "phases": {"drain": drain_s, "reroute": reroute_s},
        }
        self.scale_events.append(event)
        self._finalize(event)
        logger.warning(
            "[controller] SCALE DOWN -> %d replicas: drained %s in "
            "%.2fs (%d straggler(s) re-dispatched).",
            self.replicas, victim.name, drain_s, len(stragglers),
        )
        return victim

    # -- live weight updates + canary -----------------------------------

    def _replay(self, engine, pinned, tag):
        """Run the pinned prompts under fresh request ids and return
        ``{original rid: tokens}`` — the bit-for-bit parity oracle."""
        fresh = [
            dataclasses.replace(
                req, request_id=f"{req.request_id}__{tag}", trace_id=None,
            )
            for req in pinned
        ]
        results = engine.run(fresh, timeout_s=120.0)
        return {
            req.request_id: list(results[f.request_id])
            for req, f in zip(pinned, fresh)
        }

    def start_canary(self, params, version, pinned, target=None):
        """Begin a blue/green rollout of ``params`` as weights version
        ``version``: token-parity gate first (pinned prompts replayed
        against old then new weights on the canary replica — any
        mismatch rolls back IMMEDIATELY), then a traffic split of
        ``canary_fraction`` watched for ``canary_windows`` clean SLO
        windows before fleet-wide promotion. Returns True when the
        canary passed the parity gate (promotion may still be pending),
        False when it rolled back."""
        if self.canary is not None:
            raise SMPValidationError(
                "a canary rollout is already in progress."
            )
        if target is None:
            target = next(
                (h for h in self.router.live_handles()
                 if isinstance(h, LocalReplicaHandle)),
                None,
            )
        if target is None or not hasattr(target, "engine"):
            raise SMPValidationError(
                "canary needs a local replica handle (an engine to "
                "replay pinned prompts on)."
            )
        engine = target.engine
        version = int(version)
        if version == engine.weights_version:
            raise SMPValidationError(
                f"canary version {version} is already live."
            )
        # Drain to idle: adopt_params refuses mid-stream swaps (a stream
        # sampled under two weight versions is silently wrong output).
        stragglers = engine.drain()
        engine.resume_admission()
        reference = self._replay(engine, pinned, f"v{engine.weights_version}")
        old_params = engine.params
        old_version = engine.weights_version
        seconds = engine.adopt_params(params, version=version)
        self._append_jsonl({
            "kind": "weight_update", "version": version,
            "seconds": seconds, "t_wall": time.time(),
        })
        candidate = self._replay(engine, pinned, f"v{version}")
        for rec in stragglers:
            self.router.dispatch(serve_request_from_record(rec))
        mismatched = sorted(
            rid for rid in reference
            if candidate.get(rid) != reference[rid]
        )
        state = {
            "version": version, "old_version": old_version,
            "old_params": old_params, "params": params,
            "target": target, "windows_ok": 0,
        }
        if mismatched:
            self.canary = state
            self._rollback_canary(
                f"token_parity:{len(mismatched)}/{len(reference)} "
                "pinned prompts diverged"
            )
            return False
        target.version = version
        record_canary("started", version,
                      detail=f"fraction={self.canary_fraction:g}")
        self._append_jsonl({
            "kind": "canary", "verdict": "started", "version": version,
            "t_wall": time.time(),
            "detail": f"fraction={self.canary_fraction:g}",
        })
        if len(self.router.live_handles()) > 1:
            self.router.set_split({
                old_version: 1.0 - self.canary_fraction,
                version: self.canary_fraction,
            })
        self.canary = state
        if self.canary_windows <= 0:
            self._promote()
        return True

    def _canary_window(self, window):
        verdict = (
            evaluate_slo(self.policy.slo, window)
            if self.policy.slo else {"ok": True, "violations": {}}
        )
        if not verdict["ok"]:
            self._rollback_canary(
                "slo_window:" + ",".join(sorted(verdict["violations"]))
            )
            return
        self.canary["windows_ok"] += 1
        if self.canary["windows_ok"] >= self.canary_windows:
            self._promote()

    def _adopt_idle(self, engine, params, version):
        """Adopt between ticks: drain in-flight work first, then swap,
        then re-admit the drained stragglers on the SAME engine (their
        sampled prefixes are already committed output)."""
        stragglers = []
        if engine.in_flight or engine._queue:
            stragglers = engine.drain()
            engine.resume_admission()
        engine.adopt_params(params, version=version)
        for rec in stragglers:
            engine.submit(serve_request_from_record(rec))

    def _promote(self):
        state, self.canary = self.canary, None
        for h in self.router.live_handles():
            if h.version != state["version"] and hasattr(h, "engine"):
                self._adopt_idle(h.engine, state["params"],
                                 state["version"])
                h.version = state["version"]
        self.router.set_split(None)
        self.promotions += 1
        record_canary("promoted", state["version"])
        self._append_jsonl({
            "kind": "canary", "verdict": "promoted",
            "version": state["version"], "t_wall": time.time(),
            "detail": "",
        })
        logger.warning("[controller] canary PROMOTED: weights version "
                       "%d is live fleet-wide.", state["version"])

    def _rollback_canary(self, reason):
        state, self.canary = self.canary, None
        target = state["target"]
        self._adopt_idle(target.engine, state["old_params"],
                         state["old_version"])
        target.version = state["old_version"]
        self.router.set_split(None)
        self.rollbacks += 1
        record_canary("rolled_back", state["version"], detail=reason)
        self._append_jsonl({
            "kind": "canary", "verdict": "rolled_back",
            "version": state["version"], "t_wall": time.time(),
            "detail": reason,
        })
        _trigger_forensics(
            "canary_rollback", detail=f"version={state['version']} {reason}"
        )
        logger.warning(
            "[controller] canary ROLLED BACK (%s): weights version %d "
            "restored.", reason, state["old_version"],
        )

    # -- teardown -------------------------------------------------------

    def stop(self):
        """Close any scale event still waiting on its first token and
        unregister; idempotent."""
        self._close_pending(force=True)
        if self in _ACTIVE:
            _ACTIVE.remove(self)
