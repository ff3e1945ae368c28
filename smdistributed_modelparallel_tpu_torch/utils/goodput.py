"""Goodput ledger: exclusive-and-exhaustive wall-clock attribution
(``smp.goodput``).

Counterpart of ``smdistributed_modelparallel_tpu/utils/goodput.py``, with the
same states, metrics and env vars. It answers "where did every device-second
of this job go" by attributing EVERY second of the process's wall clock to
exactly one state:

======================  ================================================
state                   meaning
======================  ================================================
``step``                productive step compute (the only goodput state)
``trace``               program trace (the JAX package's; the port runs
                        eagerly and has none)
``compile_fresh``       a cold build: the port's kernels are built with
                        ``nvcc`` at first use (``ops/_build.py``, phase
                        ``compile/<kernel>``)
``compile_cache``       executable-cache deserialize (disk_cache hits)
``data_wait``           blocked on the input pipeline
``sync_wait``           control-plane barriers / host p2p receives
``ckpt_save``           blocking checkpoint save
``ckpt_restore``        checkpoint restore / resume
``recovery_*``          supervisor recovery phases (detect / rendezvous /
                        reshard_load / first_step)
``preempt_drain``       preemption drain + emergency-save rendezvous
``wedged``              watchdog-detected stall (or an injected wedge)
``startup``             framework bring-up (``init/*`` phases)
``idle``                none of the above
======================  ================================================

The ledger is driven from seams — the telemetry ``set_phase`` listener
(chained after the flight-recorder's), the step engine's edge hook, the
kernel builds' compile events, and explicit scopes in ``checkpoint.py``,
``utils/data.py`` and ``resilience/`` (``preempt_drain`` around an emergency
save, ``wedged`` around an injected wedge, the supervisor's ``recovery_*``)
— and maintains
the invariant (tested under a fake clock) that attributed seconds sum
to wall clock. It publishes ``smp_goodput_fraction`` plus the
``smp_goodput_seconds_total`` / ``smp_badput_seconds_total{state=}``
counters the fleet aggregator merges exactly like the histograms
(counter summing IS rank weighting), and every transition lands in the
flight recorder so ``scripts/trace_fuse.py`` can draw the badput track.

On top of the ledger sit two closed loops:

- **Perf-regression sentinel** (``SMP_REGRESSION_RATIO``): rolling-
  baseline change-point detection over windowed deltas of the
  cumulative ``smp_step_time_seconds`` / ITL histograms. When a
  window's p50 degrades past the ratio vs. the trailing-baseline
  median, it raises a latched ``smp_perf_regression`` flight event
  (one fire per episode, cleared when the p50 recovers).
- **Auto-forensics** (``SMP_FORENSICS_PATH``): when the sentinel, a
  fleet straggler/imbalance detector, an SLO violation streak, or a
  goodput drop below ``SMP_GOODPUT_MIN`` fires, capture one bounded,
  cooldown-rate-limited forensic bundle: a one-step ``torch.profiler``
  capture (reusing the ``SMP_PROFILE`` arming machinery), a flight-
  recorder ring dump, thread stacks, and the offending badput/sentinel
  windows.

Zero-cost-off contract: with none of ``SMP_GOODPUT`` /
``SMP_GOODPUT_MIN`` / ``SMP_REGRESSION_RATIO`` / ``SMP_FORENSICS_PATH``
set, ``from_env`` returns None and NOTHING is constructed — no state
machine, no listener, and every seam call is one attribute test.
"""

import collections
import contextlib
import json
import os
import statistics
import sys
import threading
import time
import traceback

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    quantile_from_counts,
    telemetry,
)

logger = get_logger()

GOODPUT_ENV = "SMP_GOODPUT"
GOODPUT_MIN_ENV = "SMP_GOODPUT_MIN"
REGRESSION_RATIO_ENV = "SMP_REGRESSION_RATIO"
FORENSICS_PATH_ENV = "SMP_FORENSICS_PATH"
FORENSICS_COOLDOWN_ENV = "SMP_FORENSICS_COOLDOWN"

#: Every attribution state, in display order. ``step`` is the single
#: productive (goodput) state; everything else is badput by definition.
STATES = (
    "step", "trace", "compile_fresh", "compile_cache", "data_wait",
    "sync_wait", "ckpt_save", "ckpt_restore", "recovery_detect",
    "recovery_rendezvous", "recovery_reshard_load", "recovery_first_step",
    "preempt_drain", "wedged", "startup", "idle",
)
PRODUCTIVE = frozenset({"step"})

#: Transitions kept for the watchdog dump / forensic bundles.
TRANSITION_HISTORY = 256

DEFAULT_TICK_SECONDS = 5.0
DEFAULT_FORENSICS_COOLDOWN = 600.0
DEFAULT_FORENSICS_MAX = 8
#: Goodput-below-min never fires this early — startup would dominate.
DEFAULT_MIN_ELAPSED = 60.0


def _flight():
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import (
        flight_recorder,
    )

    return flight_recorder


def _env_float(name):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r (want a number); ignored.", name, raw)
        return None


def goodput_enabled():
    """The ledger arms when ``SMP_GOODPUT`` is truthy OR any dependent
    knob (min-goodput gate, sentinel ratio, forensics path) is set —
    those knobs are meaningless without the ledger under them."""
    raw = os.environ.get(GOODPUT_ENV, "").strip().lower()
    if raw not in ("", "0", "off", "false", "no"):
        return True
    return any(
        os.environ.get(v)
        for v in (GOODPUT_MIN_ENV, REGRESSION_RATIO_ENV, FORENSICS_PATH_ENV)
    )


def classify_phase(phase):
    """Map a telemetry phase string to an attribution state, or None
    when the phase carries no attribution signal (state unchanged)."""
    if not phase:
        return None
    if phase.endswith("/trace"):
        return "trace"
    if phase.startswith("step_"):
        return "step"
    if phase.startswith("run/"):
        return "step"
    if phase.startswith("compile/"):
        # Tentative: exec_cache's compile event reattributes to
        # compile_cache when the executable came off disk.
        return "compile_fresh"
    if phase.startswith("init/") or phase == "startup":
        return "startup"
    if phase in ("initialized", "shutdown"):
        return "idle"
    if phase.startswith(("barrier/", "recv_from/")):
        return "sync_wait"
    return None


class RegressionSentinel:
    """Rolling-baseline change-point detector over the cumulative
    step-time / ITL histograms.

    Each ``check()`` cuts a window (bucket-count deltas vs. the previous
    check — the same arithmetic the time-series and fleet windows use)
    and compares its p50 against the median of the trailing baseline
    windows. A degradation past ``ratio`` latches the source as
    regressed (one fire per episode); recovery below the ratio clears
    it. Regressed windows never extend the baseline, so a persistent
    regression cannot normalize itself away.
    """

    SOURCES = (
        ("step_time", "smp_step_time_seconds", ()),
        ("itl", "smp_serve_latency_seconds", (("kind", "itl"),)),
    )

    def __init__(self, registry=None, ratio=None, min_count=8,
                 baseline_windows=3, history=32):
        self.registry = registry if registry is not None else telemetry
        self.ratio = (
            _env_float(REGRESSION_RATIO_ENV) if ratio is None
            else float(ratio)
        )
        self.min_count = int(min_count)
        self.baseline_windows = int(baseline_windows)
        self._prev = {}
        self._baseline = {
            src: collections.deque(maxlen=8) for src, _, _ in self.SOURCES
        }
        self._regressed = set()
        self.windows = {
            src: collections.deque(maxlen=history)
            for src, _, _ in self.SOURCES
        }
        self.verdicts = []

    @property
    def enabled(self):
        return self.ratio is not None and self.ratio > 0

    def _series(self, metrics, name, labels):
        fam = metrics.get(name)
        if not fam:
            return None
        want = tuple(sorted(labels))
        for s in fam.get("series", ()):
            if tuple(sorted((s.get("labels") or {}).items())) == want:
                return s
        return None

    def check(self, now=None, wall=None):
        """Cut one window per source; returns the list of verdicts FIRED
        by this check (empty when nothing newly regressed)."""
        if not self.enabled:
            return []
        metrics = self.registry.report().get("metrics", {})
        fired = []
        for source, fam_name, labels in self.SOURCES:
            s = self._series(metrics, fam_name, labels)
            if s is None or not s.get("counts"):
                continue
            buckets = list(s["buckets"])
            counts = list(s["counts"])
            prev = self._prev.get(source)
            self._prev[source] = (buckets, counts, s["sum"], s["count"])
            if prev is None or prev[0] != buckets:
                continue
            dcounts = [a - b for a, b in zip(counts, prev[1])]
            dn = s["count"] - prev[3]
            if dn < self.min_count or min(dcounts) < 0:
                continue
            p50 = quantile_from_counts(buckets, dcounts, 0.5)
            if p50 is None:
                continue
            base = self._baseline[source]
            record = {
                "source": source, "p50_s": round(p50, 6), "count": dn,
                "t_wall": wall if wall is not None else time.time(),
            }
            if len(base) >= self.baseline_windows:
                baseline = statistics.median(base)
                r = p50 / baseline if baseline > 0 else 1.0
                record["baseline_s"] = round(baseline, 6)
                record["ratio"] = round(r, 3)
                flag = self.registry.gauge(
                    "smp_perf_regression",
                    "1 while the windowed p50 sits past "
                    "SMP_REGRESSION_RATIO x the trailing baseline",
                )
                if r > self.ratio and source not in self._regressed:
                    self._regressed.add(source)
                    record["fired"] = True
                    self.verdicts.append(record)
                    fired.append(record)
                    self.registry.counter(
                        "smp_perf_regression_total",
                        "perf-regression sentinel fires (one per latched "
                        "episode)",
                    ).labels(source=source).inc()
                    flag.labels(source=source).set(1)
                    _flight().record_perf(
                        "regression", source,
                        detail=f"p50 {p50:.4f}s = {r:.2f}x baseline "
                               f"{baseline:.4f}s > {self.ratio:g}")
                    logger.warning(
                        "PERF REGRESSION (%s): windowed p50 %.4fs is "
                        "%.2fx the trailing baseline %.4fs "
                        "(SMP_REGRESSION_RATIO=%g).",
                        source, p50, r, baseline, self.ratio,
                    )
                elif r <= self.ratio and source in self._regressed:
                    self._regressed.discard(source)
                    flag.labels(source=source).set(0)
                    _flight().record_perf(
                        "regression_clear", source,
                        detail=f"p50 {p50:.4f}s back to {r:.2f}x baseline")
            if source not in self._regressed:
                base.append(p50)
            self.windows[source].append(record)
        return fired

    @property
    def regressed(self):
        return set(self._regressed)


class ForensicsEngine:
    """Anomaly-triggered forensic bundle capture, bounded and
    cooldown-rate-limited.

    One bundle = a directory under ``SMP_FORENSICS_PATH`` holding
    ``forensics.json`` (reason, goodput snapshot, sentinel windows,
    thread stacks), ``flight_recorder.jsonl`` (the ring dump), and — once
    the next step edge passes — a one-step ``torch.profiler`` capture
    under ``profile/`` via the ``SMP_PROFILE`` arming machinery.
    """

    def __init__(self, path=None, registry=None, cooldown=None,
                 max_bundles=DEFAULT_FORENSICS_MAX, clock=None, wall=None):
        self.path = (
            os.environ.get(FORENSICS_PATH_ENV) if path is None else path
        ) or None
        self.registry = registry if registry is not None else telemetry
        env_cd = _env_float(FORENSICS_COOLDOWN_ENV)
        self.cooldown = (
            (env_cd if env_cd is not None else DEFAULT_FORENSICS_COOLDOWN)
            if cooldown is None else float(cooldown)
        )
        self.max_bundles = int(max_bundles)
        self._clock = clock or time.monotonic
        self._wall = wall or time.time
        self._lock = threading.Lock()
        self._last = None
        self._count = 0
        self.bundles = []

    @property
    def enabled(self):
        return self.path is not None

    def _counter(self):
        return self.registry.counter(
            "smp_forensics_total",
            "auto-forensics triggers by outcome (captured / suppressed)",
        )

    def trigger(self, reason, detail="", context=None):
        """Capture one bundle, or return None when suppressed (cooldown
        not elapsed, or the bundle cap is spent). Never raises: a broken
        capture must not take down the run it is diagnosing."""
        if not self.enabled:
            return None
        with self._lock:
            now = self._clock()
            if self._count >= self.max_bundles:
                self._counter().labels(outcome="suppressed").inc()
                return None
            if self._last is not None and now - self._last < self.cooldown:
                self._counter().labels(outcome="suppressed").inc()
                return None
            self._last = now
            self._count += 1
            seq = self._count
        try:
            return self._capture(seq, reason, detail, context)
        except Exception as e:  # pragma: no cover - diagnostics only
            logger.warning("forensic capture failed: %s", e)
            return None

    def _capture(self, seq, reason, detail, context):
        bundle = self.registry._rank_path(
            os.path.join(self.path, f"bundle_{seq:03d}_{reason}")
        )
        os.makedirs(bundle, exist_ok=True)
        stacks = {}
        try:
            names = {t.ident: t.name for t in threading.enumerate()}
            for tid, frame in sys._current_frames().items():
                stacks[f"{names.get(tid, '?')}:{tid}"] = (
                    traceback.format_stack(frame)
                )
        except Exception:
            pass
        doc = {
            "kind": "forensics",
            "seq": seq,
            "reason": reason,
            "detail": detail,
            "t_wall": self._wall(),
            "pid": os.getpid(),
            "rank": self.registry.process_index,
            "threads": stacks,
        }
        if context:
            doc.update(context)
        # No compiled program, so no HLO fingerprint: the JAX package's
        # "hlo_fingerprint" key stays None.
        doc["hlo_fingerprint"] = None
        fr = _flight()
        ring_path = fr.dump(os.path.join(bundle, "flight_recorder.jsonl"))
        doc["flight_recorder"] = ring_path
        # One-step profiler capture at the next step edge, into the
        # bundle (the SIGUSR2 arming path, called in-process).
        try:
            from smdistributed_modelparallel_tpu_torch.utils import profiling

            profiling.capture.request_capture(
                path=os.path.join(bundle, "profile")
            )
            doc["profile"] = os.path.join(bundle, "profile")
        except Exception:
            doc["profile"] = None
        try:
            with open(os.path.join(bundle, "forensics.json"), "w") as f:
                json.dump(doc, f, indent=1, default=str)
        except OSError as e:
            logger.warning("forensics.json write failed: %s", e)
        self._counter().labels(outcome="captured").inc()
        fr.record_perf("forensics", reason, detail=bundle)
        self.bundles.append(bundle)
        logger.warning(
            "FORENSICS (%s): bundle %d captured under %s%s.",
            reason, seq, bundle,
            " (profiler armed for the next step)" if doc.get("profile")
            else "",
        )
        return bundle


class GoodputLedger:
    """The attribution state machine.

    A small stack models nesting: the BASE entry follows the ambient
    telemetry phase (``observe_phase``), while explicit ``scope()``
    pushes (checkpoint saves, preemption drains, injected wedges)
    temporarily outrank it. Every transition attributes the elapsed
    time since the previous one to the state being left, so at any
    instant ``sum(seconds().values()) == now - t0`` exactly — the
    invariant the fake-clock tests pin.
    """

    def __init__(self, registry=None, tick_seconds=DEFAULT_TICK_SECONDS,
                 min_goodput=None, regression_ratio=None, forensics=None,
                 min_elapsed=DEFAULT_MIN_ELAPSED, clock=None, wall=None):
        self.registry = registry if registry is not None else telemetry
        self._clock = clock or time.monotonic
        self._wall = wall or time.time
        self.tick_seconds = float(tick_seconds)
        self.min_goodput = (
            _env_float(GOODPUT_MIN_ENV) if min_goodput is None
            else float(min_goodput)
        )
        self.min_elapsed = float(min_elapsed)
        self.sentinel = RegressionSentinel(
            registry=self.registry, ratio=regression_ratio
        )
        self.forensics = (
            ForensicsEngine(registry=self.registry, clock=self._clock,
                            wall=self._wall)
            if forensics is None else forensics
        )
        self._lock = threading.RLock()
        self._t0 = self._clock()
        self._t_last = self._t0
        self._stack = ["startup"]
        self._seconds = {}
        self._transitions = collections.deque(maxlen=TRANSITION_HISTORY)
        self._published = {}
        self._last_tick = self._t0
        self._min_fired = False

    @classmethod
    def from_env(cls, registry=None):
        """The env-configured ledger, or None when no goodput knob is
        set — in which case NOTHING is constructed."""
        if not goodput_enabled():
            return None
        return cls(registry=registry)

    # -- the transition primitive ---------------------------------------

    def _shift(self, new_state, now=None):
        """Attribute elapsed time to the current state, then make
        ``new_state`` current. Caller holds the lock."""
        now = self._clock() if now is None else now
        prev = self._stack[-1]
        dt = now - self._t_last
        if dt > 0:
            self._seconds[prev] = self._seconds.get(prev, 0.0) + dt
        self._t_last = now
        if new_state != prev:
            self._transitions.append(
                (round(now - self._t0, 6), prev, new_state)
            )
            _flight().record_goodput(new_state, prev, max(dt, 0.0))
        return prev

    def _sync(self, now=None):
        self._shift(self._stack[-1], now)

    # -- inputs ---------------------------------------------------------

    def enter(self, state, now=None):
        """Unconditional transition of the current (top) state."""
        with self._lock:
            self._shift(state, now)
            self._stack[-1] = state

    def observe_phase(self, phase):
        """The telemetry ``set_phase`` listener: ambient phases drive
        the BASE of the stack only — an explicit scope (ckpt_save,
        preempt_drain, wedged) in progress outranks them."""
        state = classify_phase(phase)
        if state is None:
            return
        with self._lock:
            if len(self._stack) == 1:
                self._shift(state)
                self._stack[-1] = state
            else:
                self._stack[0] = state

    @contextlib.contextmanager
    def scope(self, state):
        """Explicitly-attributed region; restores the enclosing state
        (including ambient phase changes observed meanwhile) on exit."""
        with self._lock:
            self._shift(state)
            self._stack.append(state)
        try:
            yield self
        finally:
            with self._lock:
                if len(self._stack) > 1:
                    # Shift BEFORE popping: the elapsed interval belongs
                    # to the scope state (the current top), and the
                    # transition target is the enclosing entry.
                    self._shift(self._stack[-2])
                    self._stack.pop()

    def mark_stalled(self, reason=""):
        """Watchdog seam (called from the timer thread while the main
        thread is parked): from here on, time accrues to ``wedged``
        until the stalled thread resumes and transitions away."""
        with self._lock:
            self._shift("wedged")
            self._stack[-1] = "wedged"

    def note_compile(self, source, seconds):
        """Compile-event seam (each kernel build, ``ops/_build.py``): a
        compile phase is attributed ``compile_fresh`` tentatively (the
        source is only known when the event lands); disk-cache hits move
        their seconds over."""
        if source != "disk_cache":
            return
        with self._lock:
            self._sync()
            avail = self._seconds.get("compile_fresh", 0.0)
            moved = min(max(float(seconds), 0.0), avail)
            if moved <= 0:
                return
            self._seconds["compile_fresh"] = avail - moved
            self._seconds["compile_cache"] = (
                self._seconds.get("compile_cache", 0.0) + moved
            )

    # -- readout --------------------------------------------------------

    def seconds(self, now=None):
        """Attributed seconds by state, current state's partial interval
        included: values sum to ``wall_seconds(now)`` exactly."""
        with self._lock:
            self._sync(now)
            return dict(self._seconds)

    def wall_seconds(self, now=None):
        now = self._clock() if now is None else now
        return now - self._t0

    def goodput_fraction(self, now=None):
        secs = self.seconds(now)
        total = sum(secs.values())
        if total <= 0:
            return 1.0
        return sum(secs.get(s, 0.0) for s in PRODUCTIVE) / total

    @property
    def state(self):
        with self._lock:
            return self._stack[-1]

    def transitions(self, last=None):
        with self._lock:
            items = list(self._transitions)
        if last is not None:
            items = items[-last:]
        return [
            {"t_s": t, "from": a, "to": b} for t, a, b in items
        ]

    def snapshot(self, last=32):
        """The watchdog-dump / forensics block: current state, per-state
        seconds, goodput fraction, and the last N transitions."""
        now = self._clock()
        secs = self.seconds(now)
        return {
            "state": self.state,
            "wall_s": round(self.wall_seconds(now), 3),
            "goodput_fraction": round(self.goodput_fraction(now), 4),
            "seconds": {s: round(v, 3) for s, v in sorted(secs.items())},
            "transitions": self.transitions(last=last),
        }

    def window_block(self):
        """The per-window fold for MetricsTimeSeries records."""
        now = self._clock()
        secs = self.seconds(now)
        return {
            "fraction": round(self.goodput_fraction(now), 4),
            "badput": {
                s: round(v, 3) for s, v in sorted(secs.items())
                if s not in PRODUCTIVE and v > 0
            },
        }

    # -- publishing + the closed loops ----------------------------------

    def publish(self, now=None):
        """Refresh the gauges and bump the cumulative second counters by
        the delta since the last publish (counters must stay monotonic
        so the fleet merge can sum them across ranks)."""
        now = self._clock() if now is None else now
        with self._lock:
            secs = self.seconds(now)
            frac = self.goodput_fraction(now)
            good_c = self.registry.counter(
                "smp_goodput_seconds_total",
                "wall-clock seconds attributed to productive step compute",
            )
            bad_c = self.registry.counter(
                "smp_badput_seconds_total",
                "wall-clock seconds attributed to non-productive states",
            )
            for s, v in secs.items():
                d = v - self._published.get(s, 0.0)
                if d <= 0:
                    continue
                if s in PRODUCTIVE:
                    good_c.inc(d)
                else:
                    bad_c.labels(state=s).inc(d)
                self._published[s] = v
        self.registry.gauge(
            "smp_goodput_fraction",
            "fraction of this rank's wall clock attributed to productive "
            "step compute",
        ).set(frac)
        return frac

    def maybe_tick(self, now=None):
        """The periodic tick (step edges / time-series samples): at
        most once per ``tick_seconds``, publish, run the sentinel, and
        evaluate the goodput floor. Cheap otherwise."""
        now = self._clock() if now is None else now
        with self._lock:
            if now - self._last_tick < self.tick_seconds:
                return None
            self._last_tick = now
        return self.tick(now)

    def tick(self, now=None):
        now = self._clock() if now is None else now
        frac = self.publish(now)
        fired = self.sentinel.check(now=now, wall=self._wall())
        for verdict in fired:
            self.trigger_forensics(
                "perf_regression",
                detail=f"{verdict['source']} p50 {verdict['p50_s']}s "
                       f"ratio {verdict.get('ratio')}",
            )
        if (self.min_goodput is not None
                and not self._min_fired
                and self.wall_seconds(now) >= self.min_elapsed
                and frac < self.min_goodput):
            self._min_fired = True
            _flight().record_perf(
                "goodput_min", "goodput",
                detail=f"{frac:.3f} < {self.min_goodput:g}")
            self.trigger_forensics(
                "goodput_min",
                detail=f"goodput {frac:.3f} < SMP_GOODPUT_MIN "
                       f"{self.min_goodput:g}",
            )
        return frac

    def on_step_edge(self, step):
        self.maybe_tick()

    def trigger_forensics(self, reason, detail=""):
        context = {
            "goodput": self.snapshot(),
            "sentinel": {
                "verdicts": list(self.sentinel.verdicts),
                "windows": {
                    src: list(win)
                    for src, win in self.sentinel.windows.items() if win
                },
            },
        }
        return self.forensics.trigger(reason, detail=detail,
                                      context=context)

    def bench_block(self, now=None):
        """The ``"goodput"`` block of a benchmark record (``bench.py``'s)."""
        now = self._clock() if now is None else now
        secs = self.seconds(now)
        return {
            "fraction": round(self.goodput_fraction(now), 4),
            "wall_s": round(self.wall_seconds(now), 3),
            "seconds": {s: round(v, 3) for s, v in sorted(secs.items())},
            "sentinel": list(self.sentinel.verdicts),
            "forensics": list(self.forensics.bundles),
        }


class GoodputController:
    """Process-wide singleton (``smp.goodput``): owns the ledger's
    lifecycle and the ``set_phase`` listener chain. Every accessor is a
    single attribute test while disarmed."""

    def __init__(self):
        self.ledger = None
        self._chained = None
        self._prev_listener = None

    def start(self, registry=None):
        """Arm from the environment (state.initialize); idempotent.
        Chains the phase listener AFTER the flight-recorder's so phases
        keep flowing to the ring."""
        if self.ledger is not None:
            return self.ledger
        led = GoodputLedger.from_env(registry=registry)
        if led is None:
            return None
        self.ledger = led
        reg = led.registry
        prev = reg._phase_listener

        def _chain(phase, _prev=prev, _led=led):
            if _prev is not None:
                _prev(phase)
            _led.observe_phase(phase)

        self._prev_listener = prev
        self._chained = _chain
        reg._phase_listener = _chain
        logger.info(
            "goodput ledger armed (min=%s, regression_ratio=%s, "
            "forensics=%s).", led.min_goodput, led.sentinel.ratio,
            led.forensics.path,
        )
        return led

    def stop(self):
        """Final publish + unchain; idempotent."""
        led = self.ledger
        if led is None:
            return
        try:
            led.tick()
        except Exception:
            logger.warning("goodput final tick failed", exc_info=True)
        reg = led.registry
        if reg._phase_listener is self._chained:
            reg._phase_listener = self._prev_listener
        self._chained = None
        self._prev_listener = None

    def reset(self):
        """Testing hook (state.reset): drop the ledger entirely."""
        self.stop()
        self.ledger = None

    # -- seam helpers (one attribute test each while disarmed) ----------

    def scope(self, state):
        led = self.ledger
        return led.scope(state) if led is not None else _NULL_SCOPE

    def enter(self, state):
        led = self.ledger
        if led is not None:
            led.enter(state)

    def on_step_edge(self, step):
        led = self.ledger
        if led is not None:
            led.on_step_edge(step)

    def note_compile(self, source, seconds):
        led = self.ledger
        if led is not None:
            led.note_compile(source, seconds)

    def mark_stalled(self, reason=""):
        led = self.ledger
        if led is not None:
            led.mark_stalled(reason)

    def trigger_forensics(self, reason, detail=""):
        led = self.ledger
        if led is not None:
            return led.trigger_forensics(reason, detail=detail)
        return None

    def snapshot(self):
        led = self.ledger
        return led.snapshot() if led is not None else None

    def window_block(self):
        led = self.ledger
        return led.window_block() if led is not None else None

    def bench_block(self):
        led = self.ledger
        return led.bench_block() if led is not None else None


_NULL_SCOPE = contextlib.nullcontext()

goodput = GoodputController()
