"""Deterministic chaos / fault-injection harness of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/resilience/chaos.py``, with
the same grammar, faults, metric and ring events. The step edge
(``on_step_edge``), the step's dispatch (``on_step_dispatch``), the serving
engine's decode tick (``on_serve_decode``) and its ``adopt_params``
(``on_weight_update``) call it, and, where the JAX package calls them, the
native bus's sends (``on_bus_send``, ``backend/native.py``), the host
collectives (``on_collective``, ``backend/collectives.py``) and the failure
detector's heartbeats (``on_heartbeat``, ``resilience/supervisor.py``).
``on_scale_event`` has no caller yet: the serving controller comes with ROADMAP
item 5b.

Production resilience claims are worthless untested: "we recover from a
preempted rank" has to be demonstrated against an *actual* preempted rank.
This module is the one switchboard for injecting those faults, driven by
the ``SMP_CHAOS`` environment variable so a chaos run needs no code
changes — the same training script, plus a fault spec.

Spec grammar (comma-separated rules; each ``fault@key=value[:key=value...]``)::

    SMP_CHAOS="sigterm@step=3:rank=0,delay_collective@group=pp:ms=200"

Faults:

- ``sigterm@step=N[:rank=R]`` — deliver SIGTERM to this process at the end
  of step ``N`` (the step-engine edge in ``step.py``). With the preemption
  listener installed (``resilience/preemption.py``) this exercises the full
  emergency-checkpoint path; without it the process dies like a real
  preemption with no grace handling.
- ``kill@step=N[:rank=R]`` — deliver SIGKILL at the end of step ``N``: no
  grace, no handler, no emergency checkpoint — the hard-failure case the
  in-job recovery supervisor (``resilience/supervisor.py``) exists for.
  Peers see missed heartbeats and a dead bus link, never a notice.
- ``wedge@step=N[:rank=R]:ms=M`` — hang for ``M`` ms INSIDE step ``N``'s
  dispatch (before the step's microbatches run). Heartbeats keep flowing
  (the detector thread is alive) but this rank's reported step edge stops
  advancing: the peers' detectors classify it **wedged** once the stall
  exceeds ``SMP_WEDGE_TIMEOUT``.
- ``heartbeat_drop@rank=R:count=K`` — silently drop process ``R``'s next
  ``K`` outgoing heartbeats (all peers): false-positive/flap testing for
  the failure detector — ``K`` below the miss budget must NOT produce a
  dead classification, above it must.
- ``kill_replica@request=N[:rank=R]`` — SIGKILL a SERVING replica
  mid-decode: fires at the first decode-step boundary where the
  replica's ``N``-th admitted request (1-based) has produced at least
  one token and is still unfinished. The replica-failover layer
  (``serving/replica.py``) must detect the death over the heartbeat bus
  and the survivor re-admit every unfinished request from its mirrored
  logs.
- ``kill_replica@scale=K[:rank=R]`` — SIGKILL this process right after
  the controller's ``K``-th completed autoscale event (1-based,
  ``serving/controller.py`` seam): the scale-up/scale-down edge is
  exactly when replica bookkeeping is most easily corrupted, so the
  failover path must absorb a death there too.
- ``corrupt_weights@version=N[:rank=R]`` — perturb the parameter tree a
  serving replica adopts as weights version ``N`` (every float leaf
  mapped to ``x * 1.01 + 0.01`` — deterministic, and the affine shift
  breaks greedy token parity even where a pure rescale would preserve
  every argmax): the canary's token-parity gate must catch it and the
  controller auto-roll back, latching ``smp_canary_rollback_total`` and
  one forensics bundle.
- ``bus_drop@seq=N[:rank=R][:dest=D]`` — silently drop this process's
  ``N``-th native-bus send (0-based ordinal over all sends; heartbeats
  ride their own seam and do not consume ordinals). The receiver never
  sees the message: exercises watchdog/timeout recovery.
- ``bus_error@seq=N[:rank=R][:dest=D]`` — fail the ``N``-th send at the
  enqueue edge: exercises the bounded retry/backoff and ``SMPPeerLost``
  path in ``backend/native.py``.
- ``delay_collective@group=G:ms=M[:count=C]`` — sleep ``M`` ms before each
  host collective whose group name starts with ``G`` (case-insensitive;
  e.g. ``pp`` matches ``PP_GROUP``), at most ``C`` times (default
  unlimited): manufactures stragglers for the observability stack.

``rank=R`` restricts a rule to process index ``R`` (default: every
process). Rules are deterministic — ordinals and step numbers are exact,
never sampled — so a chaos failure reproduces byte-for-byte.

Seams live in ``step.py`` (``on_step_edge``, ``on_step_dispatch``),
``backend/native.py`` (``on_bus_send``), ``backend/collectives.py``
(``on_collective``) and ``resilience/supervisor.py`` (``on_heartbeat``). Every
seam's disabled path is one ``os.environ.get`` — a run without ``SMP_CHAOS``
pays nothing. Injections are counted in ``smp_chaos_injected_total`` and
recorded as flight-recorder ``chaos`` events so a post-mortem ring always
shows which faults were synthetic.

Import-hygiene contract: stdlib + the package logger/telemetry only.
"""

import os
import signal
import time

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    record_chaos,
    telemetry,
)

logger = get_logger()

CHAOS_ENV = "SMP_CHAOS"

_KNOWN_FAULTS = (
    "sigterm", "kill", "wedge", "heartbeat_drop",
    "bus_drop", "bus_error", "delay_collective", "kill_replica",
    "corrupt_weights",
)

# Argument value parsers: validated at PARSE time so a typo degrades to a
# skipped rule with a warning — never a ValueError at a seam mid-run.
_NUMERIC_KEYS = {
    "step": int, "rank": int, "seq": int, "dest": int, "count": int,
    "ms": float, "request": int, "scale": int, "version": int,
}


class _Rule:
    __slots__ = ("fault", "kv", "fired")

    def __init__(self, fault, kv):
        self.fault = fault
        self.kv = kv
        self.fired = 0

    def rank_matches(self):
        r = self.kv.get("rank")
        return r is None or int(r) == int(telemetry.process_index or 0)

    def __repr__(self):
        return f"_Rule({self.fault}, {self.kv}, fired={self.fired})"


def parse_spec(spec):
    """Parse an ``SMP_CHAOS`` spec string into rules. Malformed rules are
    skipped with a warning — a typo in a chaos spec must degrade to "no
    fault", never crash the training run it was meant to probe."""
    rules = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        fault, _, args = raw.partition("@")
        fault = fault.strip()
        if fault not in _KNOWN_FAULTS:
            logger.warning(
                "%s: unknown fault %r in rule %r (known: %s); skipping.",
                CHAOS_ENV, fault, raw, ", ".join(_KNOWN_FAULTS),
            )
            continue
        kv = {}
        ok = True
        for part in filter(None, args.split(":")):
            k, sep, v = part.partition("=")
            if not sep or not k or not v:
                logger.warning(
                    "%s: malformed argument %r in rule %r; skipping rule.",
                    CHAOS_ENV, part, raw,
                )
                ok = False
                break
            k, v = k.strip(), v.strip()
            conv = _NUMERIC_KEYS.get(k)
            if conv is not None:
                try:
                    conv(v)
                except ValueError:
                    logger.warning(
                        "%s: non-numeric %s=%r in rule %r; skipping rule.",
                        CHAOS_ENV, k, v, raw,
                    )
                    ok = False
                    break
            kv[k] = v
        if ok:
            rules.append(_Rule(fault, kv))
    return rules


class ChaosInjector:
    """Singleton switchboard; seams call the ``on_*`` hooks.

    The spec is re-read lazily (one env lookup + string compare per seam
    call) so tests and operators can arm/disarm faults mid-process; rule
    fire-counters and the bus-send ordinal reset when the spec changes.
    """

    def __init__(self):
        self._spec = ""
        self._rules = []
        self._bus_send_ordinal = 0

    def _sync(self):
        spec = os.environ.get(CHAOS_ENV, "")
        if spec != self._spec:
            self._spec = spec
            self._rules = parse_spec(spec) if spec else []
            self._bus_send_ordinal = 0
            if self._rules:
                logger.warning(
                    "chaos harness ARMED: %d rule(s) from %s=%r",
                    len(self._rules), CHAOS_ENV, spec,
                )
        return self._rules

    @property
    def enabled(self):
        return bool(self._sync())

    @property
    def rules(self):
        return list(self._sync())

    # -- seams ----------------------------------------------------------

    def on_step_edge(self, step):
        """step.py seam: called once per completed step with the step
        count. May deliver SIGTERM (rule ``sigterm``) — graceful, the
        preemption listener defers it — or SIGKILL (rule ``kill``) — the
        hard death the failure detector must notice on its own."""
        if not os.environ.get(CHAOS_ENV):
            return
        for r in self._sync():
            if (
                r.fault in ("sigterm", "kill")
                and not r.fired
                and r.rank_matches()
                and int(r.kv.get("step", -1)) == int(step)
            ):
                r.fired += 1
                record_chaos(r.fault, f"step={step}")
                signum = (
                    signal.SIGKILL if r.fault == "kill" else signal.SIGTERM
                )
                logger.warning(
                    "chaos: delivering %s to pid %d at step %s",
                    signum.name, os.getpid(), step,
                )
                os.kill(os.getpid(), signum)

    def on_step_dispatch(self, step):
        """step.py seam: called as step ``step``'s dispatch begins (before
        the step's microbatches run). May hang this rank for ``ms``
        milliseconds (rule ``wedge``): its heartbeat thread keeps beating
        but the reported step edge stalls — the peers' detectors must
        classify it wedged, not dead."""
        if not os.environ.get(CHAOS_ENV):
            return
        for r in self._sync():
            if (
                r.fault == "wedge"
                and not r.fired
                and r.rank_matches()
                and int(r.kv.get("step", -1)) == int(step)
            ):
                r.fired += 1
                ms = float(r.kv.get("ms", 0))
                record_chaos("wedge", f"step={step} ms={ms:g}")
                logger.warning(
                    "chaos: wedging pid %d inside step %s dispatch for "
                    "%gms", os.getpid(), step, ms,
                )
                if ms > 0:
                    from smdistributed_modelparallel_tpu_torch.utils.goodput import (
                        goodput,
                    )

                    # The injected stall is exactly what the ledger's
                    # `wedged` state models — attribute it there so the
                    # chaos smoke can assert the badput breakdown.
                    with goodput.scope("wedged"):
                        time.sleep(ms / 1000.0)

    def on_serve_decode(self, progress):
        """serving/engine.py seam: called once per decode-step boundary.
        ``progress(n)`` reports ``(tokens_emitted, finished)`` for the
        engine's n-th admitted request, or None when fewer than n were
        admitted. Rule ``kill_replica@request=N`` SIGKILLs this process
        the first time request N is mid-decode (>= 1 token, unfinished)
        — the hard replica death the serving failover must absorb."""
        if not os.environ.get(CHAOS_ENV):
            return
        for r in self._sync():
            if r.fault != "kill_replica" or r.fired or not r.rank_matches():
                continue
            n = int(r.kv.get("request", -1))
            got = progress(n) if n >= 1 else None
            if got is None:
                continue
            tokens, finished = got
            if finished or tokens < 1:
                continue
            r.fired += 1
            record_chaos("kill_replica", f"request={n} tokens={tokens}")
            logger.warning(
                "chaos: SIGKILL of serving replica pid %d with request "
                "#%d mid-decode (%d tokens emitted)",
                os.getpid(), n, tokens,
            )
            os.kill(os.getpid(), signal.SIGKILL)

    def on_scale_event(self, n):
        """serving/controller.py seam: called once after the controller's
        ``n``-th completed autoscale event (1-based). Rule
        ``kill_replica@scale=K`` SIGKILLs this process right at that
        edge — the moment replica bookkeeping (routing table, mirror
        shadows, standby handshakes) is most fragile."""
        if not os.environ.get(CHAOS_ENV):
            return
        for r in self._sync():
            if r.fault != "kill_replica" or r.fired or not r.rank_matches():
                continue
            k = int(r.kv.get("scale", -1))
            if k < 1 or k != int(n):
                continue
            r.fired += 1
            record_chaos("kill_replica", f"scale={k}")
            logger.warning(
                "chaos: SIGKILL of pid %d after autoscale event #%d",
                os.getpid(), k,
            )
            os.kill(os.getpid(), signal.SIGKILL)

    def on_weight_update(self, version, params):
        """serving/engine.py seam: called with the parameter tree a
        replica is about to adopt as weights version ``version``. Rule
        ``corrupt_weights@version=N`` returns a perturbed copy (every
        float leaf mapped to ``x * 1.01 + 0.01``) — silently wrong
        weights the canary's token-parity gate must catch. Returns
        ``params`` untouched otherwise."""
        if not os.environ.get(CHAOS_ENV):
            return params
        for r in self._sync():
            if (
                r.fault != "corrupt_weights"
                or r.fired
                or not r.rank_matches()
                or int(r.kv.get("version", -1)) != int(version)
            ):
                continue
            r.fired += 1
            record_chaos("corrupt_weights", f"version={version}")
            logger.warning(
                "chaos: corrupting weights version %s (float leaves "
                "-> x*1.01 + 0.01)", version,
            )
            from smdistributed_modelparallel_tpu_torch.backend.split import tree_map

            def _perturb(x):
                if hasattr(x, "dtype") and "float" in str(x.dtype):
                    return x * 1.01 + 0.01
                return x

            return tree_map(_perturb, params)
        return params

    def on_heartbeat(self, dest):
        """supervisor.py seam: called once per outgoing heartbeat. Returns
        True to silently drop the beat (rule ``heartbeat_drop``; ``count``
        beats, counted per send, any destination). Deliberately separate
        from ``on_bus_send``: beats must not consume the deterministic
        bus-send ordinals that ``bus_drop``/``bus_error`` rules target."""
        if not os.environ.get(CHAOS_ENV):
            return False
        for r in self._sync():
            if r.fault != "heartbeat_drop" or not r.rank_matches():
                continue
            count = int(r.kv.get("count", 1) or 1)
            if r.fired >= count:
                continue
            r.fired += 1
            record_chaos("heartbeat_drop", f"dest={dest} n={r.fired}/{count}")
            return True
        return False

    def on_bus_send(self, dest):
        """native.py seam: called once per bus send (consumes one send
        ordinal). Returns ``"drop"`` (silently discard the payload),
        ``"error"`` (force the enqueue to fail) or None (send normally)."""
        if not os.environ.get(CHAOS_ENV):
            return None
        rules = self._sync()
        ordinal = self._bus_send_ordinal
        self._bus_send_ordinal += 1
        for r in rules:
            if r.fault not in ("bus_drop", "bus_error") or r.fired:
                continue
            if not r.rank_matches():
                continue
            if int(r.kv.get("seq", -1)) != ordinal:
                continue
            if "dest" in r.kv and int(r.kv["dest"]) != int(dest):
                continue
            r.fired += 1
            record_chaos(r.fault, f"dest={dest} seq={ordinal}")
            logger.warning(
                "chaos: %s of bus send #%d to process %d",
                r.fault, ordinal, dest,
            )
            return "drop" if r.fault == "bus_drop" else "error"
        return None

    def on_collective(self, op, group_name):
        """collectives.py seam: called before a host collective executes.
        May sleep (rule ``delay_collective``) to manufacture a straggler."""
        if not os.environ.get(CHAOS_ENV):
            return
        for r in self._sync():
            if r.fault != "delay_collective" or not r.rank_matches():
                continue
            count = int(r.kv.get("count", 0) or 0)
            if count and r.fired >= count:
                continue
            g = r.kv.get("group")
            if g and not str(group_name).lower().startswith(g.lower()):
                continue
            ms = float(r.kv.get("ms", 0))
            if ms <= 0:
                continue
            r.fired += 1
            record_chaos("delay_collective", f"op={op} group={group_name}")
            time.sleep(ms / 1000.0)

    def reset(self):
        """Testing hook: forget the cached spec, counters and ordinals."""
        self._spec = ""
        self._rules = []
        self._bus_send_ordinal = 0


chaos = ChaosInjector()
