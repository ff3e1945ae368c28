"""Process-wide telemetry registry + hang watchdog (``smp.telemetry``,
``smp.watchdog``).

Counterpart of ``smdistributed_modelparallel_tpu/utils/telemetry.py``, with
the same metric names, label keys, env vars and dump format, so the stdlib
scripts (``scripts/telemetry_report.py``, ``slo_report.py``, ``trace_fuse.py``,
``perf_ledger.py``) read either package's dumps. A thread-safe registry of
counters, gauges and histograms (all with optional labels) that the layers of
the port feed:

- ``step.py`` / ``utils/metrics.py``: step counts and times, the sampled
  roofline, per-step peak device memory (``torch.cuda.memory_stats``);
- ``serving/engine.py``: request lifecycle counts, latency histograms,
  occupancy gauges, per-request flight-recorder spans;
- ``nn/transformer.py`` / ``nn/utils.py`` / ``quant.py``: fused-kernel and
  low-precision dispatch decisions and the fp8 scaling state;
- ``generation.py``: shape-bucket outcomes; ``fp16/loss_scaler.py``: the
  loss-scale events; ``resilience/elastic.py``: elastic resumes.

Exports: ``smp.telemetry.report()`` (plain dict), ``render_prometheus()``
(text exposition format), and a JSON dump — written on demand, at
``smp.shutdown``, and from an ``atexit`` hook — to ``SMP_TELEMETRY_PATH``.
``scripts/telemetry_report.py`` pretty-prints the dump. The resilience
recorders (``record_health_check``/``_trip``/``_fault``,
``record_update_stats``, ``record_oom``, ``record_chaos``,
``record_preemption``, ``record_failure_detected``, ``record_recovery``) and
the serving control plane's (``record_scale_event``,
``record_controller_replicas``, ``record_route``, ``record_drain_stragglers``,
``record_canary``) and the pipeline schedules' (``record_pipeline_occupancy``)
are the JAX package's; the executable cache's come with it.

The **watchdog** (``SMP_WATCHDOG_TIMEOUT`` seconds; unset/0 = off) turns
silent wedges into actionable dumps: when a guarded operation overruns the
timeout, the full registry state, the per-rank last-known phase, and every
thread's stack are written to stderr and to ``SMP_WATCHDOG_PATH`` (default
``smp_watchdog_dump.json``). Pollable waits additionally *raise*
``SMPWatchdogTimeout`` instead of blocking forever; non-interruptible waits
dump from a timer thread and keep waiting — the dump is the diagnostic.

Import-hygiene contract: this module must import nothing that initializes
an accelerator backend (stdlib + the package logger/exceptions only).
"""

import atexit
import copy
import json
import os
import sys
import threading
import time
import traceback

from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPWatchdogTimeout
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

TELEMETRY_PATH_ENV = "SMP_TELEMETRY_PATH"
WATCHDOG_TIMEOUT_ENV = "SMP_WATCHDOG_TIMEOUT"
WATCHDOG_PATH_ENV = "SMP_WATCHDOG_PATH"

# Powers-of-4 seconds-scale buckets: host control-plane operations span
# ~1ms (local bus delivery) to minutes (kernel builds, long steps).
DEFAULT_BUCKETS = (
    0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 16.0, 64.0, 256.0,
)


def _geometric_buckets(lo, hi, growth):
    """Geometric bucket boundaries ``lo * growth**i`` up to the first
    boundary >= ``hi``. Deterministic (the same tuple in every process),
    which is what makes per-rank histogram dumps mergeable by
    element-wise count addition."""
    out = []
    b = float(lo)
    while b < hi:
        out.append(round(b, 9))
        b *= growth
    out.append(round(b, 9))
    return tuple(out)


# Log-spaced buckets behind the streaming percentile histograms:
# 0.5 ms .. ~4 min at 1.3x growth (~50 buckets — fixed memory however
# many samples stream through). Serving latencies (queue wait, TTFT,
# ITL, prefill, decode step) and training step times all live in this
# range; the relative quantile error is bounded by the growth factor.
LATENCY_BUCKETS = _geometric_buckets(5e-4, 240.0, 1.3)

#: Serving latency distributions the engine feeds (the ``kind`` label of
#: ``smp_serve_latency_seconds`` and the stem of the per-kind gauges).
SERVE_LATENCY_KINDS = ("ttft", "itl", "queue_wait", "prefill",
                       "decode_step")


def quantile_from_counts(buckets, counts, q):
    """Estimate the q-quantile (0..1) of a bucketed distribution.

    Log-interpolates inside geometric buckets (linearly inside the first
    bucket, which starts at 0); the overflow bucket clamps to the last
    boundary. Returns None for an empty histogram. Operates on the
    (buckets, counts) lists a histogram snapshot/dump carries, so report
    scripts can compute percentiles of cross-rank MERGED counts with the
    same arithmetic (``scripts/telemetry_report.py`` keeps a stdlib
    copy)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = min(max(float(q), 0.0), 1.0) * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c > 0 and acc + c >= target:
            if i >= len(buckets):
                return float(buckets[-1])
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            f = (target - acc) / c
            if lo > 0.0:
                return float(lo * (hi / lo) ** f)
            return float(lo + (hi - lo) * f)
        acc += c
    return float(buckets[-1])


def merge_metric_reports(reports):
    """Merge per-rank telemetry reports into ONE fleet-level report:
    counters and histogram series summed element-wise across ranks
    (bucket-count addition — every rank shares the same deterministic
    bucket tuples, so merged percentiles via ``quantile_from_counts``
    are exact), gauges maxed (peak device memory keeps the worst device). Series
    are matched by (metric, label-set).

    This is the single cross-rank merge: the live fleet aggregator
    (``utils/fleet.py``), ``scripts/telemetry_report.py --dir`` and
    ``scripts/slo_report.py --fleet`` all call it, so an offline merge
    of per-rank dumps is bit-equal to the on-fleet live view.

    ``reports`` is either ``{rank: report}`` or an iterable of reports
    (ranks then come from each report's own meta, falling back to load
    order). Inputs are not mutated.
    """
    if isinstance(reports, dict):
        items = [(r, reports[r]) for r in sorted(reports)]
    else:
        items = [
            (rep.get("meta", {}).get("rank", i) if isinstance(rep, dict)
             else i, rep)
            for i, rep in enumerate(reports)
        ]
    out = {"meta": {"ranks": [r for r, _ in items]}, "metrics": {}}
    for _, report in items:
        for name, fam in report.get("metrics", {}).items():
            ofam = out["metrics"].setdefault(
                name, {"kind": fam["kind"], "help": fam.get("help", ""),
                       "series": []},
            )
            for series in fam.get("series", []):
                key = _label_key(series.get("labels", {}))
                dst = None
                for s in ofam["series"]:
                    if _label_key(s.get("labels", {})) == key:
                        dst = s
                        break
                if dst is None:
                    ofam["series"].append(copy.deepcopy(series))
                    continue
                if fam["kind"] == "histogram":
                    dst["sum"] = dst.get("sum", 0.0) + series.get("sum", 0.0)
                    dst["count"] = dst.get("count", 0) + series.get("count", 0)
                    if dst.get("buckets") == series.get("buckets"):
                        dst["counts"] = [
                            a + b for a, b in zip(dst["counts"],
                                                  series["counts"])
                        ]
                    else:
                        # Mixed-build dumps: sum/count merge fine, the
                        # per-bucket distribution cannot — say so rather
                        # than render a distribution that doesn't add up.
                        logger.warning(
                            "histogram %s has differing buckets across "
                            "ranks; merged bucket counts reflect only "
                            "the first rank", name,
                        )
                elif fam["kind"] == "counter":
                    dst["value"] = dst.get("value", 0) + series.get("value", 0)
                else:  # gauge: keep the worst rank
                    dst["value"] = max(dst.get("value", 0),
                                       series.get("value", 0))
    return out


def render_prometheus_report(report):
    """Prometheus text exposition of a report dict — the live registry's
    ``report()`` or a ``merge_metric_reports`` fleet view (the fleet
    scrape endpoint renders merged metrics through this same path)."""
    out = []
    for name, fam in sorted(report.get("metrics", {}).items()):
        if fam.get("help"):
            out.append(f"# HELP {name} {fam['help']}")
        out.append(f"# TYPE {name} {fam['kind']}")
        for series in fam["series"]:
            lab = ",".join(
                f'{k}="{v}"' for k, v in sorted(series["labels"].items())
            )
            if fam["kind"] == "histogram":
                acc = 0
                for b, c in zip(
                    list(series["buckets"]) + ["+Inf"], series["counts"]
                ):
                    acc += c
                    ble = (lab + "," if lab else "") + f'le="{b}"'
                    out.append(f"{name}_bucket{{{ble}}} {acc}")
                sfx = f"{{{lab}}}" if lab else ""
                out.append(f"{name}_sum{sfx} {series['sum']}")
                out.append(f"{name}_count{sfx} {series['count']}")
            else:
                sfx = f"{{{lab}}}" if lab else ""
                out.append(f"{name}{sfx} {series['value']}")
    return "\n".join(out) + "\n"


def _label_key(labels):
    return tuple(sorted(labels.items()))


def _atomic_json_dump(payload, path, what):
    """Temp-file + rename so a reader (or a concurrent writer) never sees a
    torn JSON. Returns the path written, or None on failure."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path
    except OSError as e:
        logger.warning("%s to %s failed: %s", what, path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


class _Child:
    """One (metric, label-set) time series. Thread-safe."""

    def __init__(self, kind, labels, buckets=None):
        self._kind = kind
        self._labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0
        if kind == "histogram":
            self._buckets = tuple(buckets or DEFAULT_BUCKETS)
            self._counts = [0] * (len(self._buckets) + 1)
            self._sum = 0.0
            self._count = 0

    # -- counter / gauge --

    def inc(self, value=1):
        if self._kind == "counter" and value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += value

    def dec(self, value=1):
        if self._kind != "gauge":
            raise ValueError("dec() is gauge-only")
        with self._lock:
            self._value -= value

    def set(self, value):
        if self._kind != "gauge":
            raise ValueError("set() is gauge-only")
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value

    # -- histogram --

    def observe(self, value):
        if self._kind != "histogram":
            raise ValueError("observe() is histogram-only")
        v = float(value)
        with self._lock:
            i = 0
            while i < len(self._buckets) and v > self._buckets[i]:
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def _snapshot(self):
        with self._lock:
            if self._kind == "histogram":
                return {
                    "labels": self._labels,
                    "buckets": list(self._buckets),
                    "counts": list(self._counts),
                    "sum": self._sum,
                    "count": self._count,
                }
            return {"labels": self._labels, "value": self._value}


class _Family:
    """A named metric; ``labels(**kw)`` returns the per-label-set child.

    Label-less metrics proxy inc/dec/set/observe/value straight to their
    single default child, so ``registry.counter("x").inc()`` works.
    """

    def __init__(self, name, kind, help="", buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children = {}

    def labels(self, **kw):
        key = _label_key(kw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self.kind, kw, self._buckets)
                self._children[key] = child
            return child

    def _default(self):
        return self.labels()

    def inc(self, value=1):
        self._default().inc(value)

    def dec(self, value=1):
        self._default().dec(value)

    def set(self, value):
        self._default().set(value)

    def observe(self, value):
        self._default().observe(value)

    @property
    def value(self):
        return self._default().value

    def _snapshot(self):
        with self._lock:
            children = list(self._children.values())
        return {
            "kind": self.kind,
            "help": self.help,
            "series": [c._snapshot() for c in children],
        }


class TelemetryRegistry:
    """Process-wide metric registry. All methods are thread-safe;
    registration is idempotent (same name -> same family) but re-registering
    a name under a different kind is a bug and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}
        self._phase = "startup"
        self._phase_ts = time.time()
        self._phase_history = []
        self._created = time.time()
        # Set by backend/state.py at smp.init (asking the backend at dump
        # time could itself hang on a wedged device at exit).
        self.process_index = None
        self.process_count = 1
        # Installed by utils/flight_recorder.py at import: phase
        # transitions flow into the flight-recorder ring without this
        # module importing it (telemetry must stay the leaf of the
        # observability import graph).
        self._phase_listener = None

    # -- registration ---------------------------------------------------

    def _family(self, name, kind, help, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}"
                )
            return fam

    def counter(self, name, help=""):
        return self._family(name, "counter", help)

    def gauge(self, name, help=""):
        return self._family(name, "gauge", help)

    def histogram(self, name, help="", buckets=None):
        return self._family(name, "histogram", help, buckets)

    # -- phase tracking (consumed by the watchdog dump) -----------------

    def set_phase(self, phase):
        """Record the process's last-known phase (e.g. "step_3/compile").
        Bounded history so a wedged run's dump shows how it got there."""
        with self._lock:
            self._phase = phase
            self._phase_ts = time.time()
            self._phase_history.append((phase, self._phase_ts))
            if len(self._phase_history) > 64:
                del self._phase_history[:-64]
        listener = self._phase_listener
        if listener is not None:
            listener(phase)

    @property
    def phase(self):
        with self._lock:
            return self._phase

    # -- export ---------------------------------------------------------

    def report(self):
        """Plain-dict snapshot of every metric plus phase metadata."""
        with self._lock:
            families = dict(self._families)
            meta = {
                "pid": os.getpid(),
                "rank": self.process_index,
                "world": self.process_count,
                "created": self._created,
                "exported": time.time(),
                "phase": self._phase,
                "phase_age_seconds": time.time() - self._phase_ts,
                "phase_history": [
                    {"phase": p, "time": t} for p, t in self._phase_history
                ],
            }
        return {
            "meta": meta,
            "metrics": {n: f._snapshot() for n, f in families.items()},
        }

    def render_prometheus(self):
        """Prometheus text exposition format (for scraping or eyeballing)."""
        return render_prometheus_report(self.report())

    def _rank_path(self, path):
        """Multi-process runs write per-rank files: N processes dumping the
        one SMP_TELEMETRY_PATH (shared filesystem) would clobber each other."""
        if self.process_count > 1 and self.process_index is not None:
            return f"{path}.rank{self.process_index}"
        return path

    def dump(self, path=None):
        """Write the JSON report (atomically; rank-suffixed under
        multi-process). Explicit ``path`` wins; otherwise
        ``SMP_TELEMETRY_PATH`` (no-op when neither is set). Returns the
        path written, or None."""
        path = path or os.environ.get(TELEMETRY_PATH_ENV)
        if not path:
            return None
        path = self._rank_path(path)
        return _atomic_json_dump(self.report(), path, "telemetry dump")

    def reset(self):
        """Testing hook: drop every metric and the phase history."""
        with self._lock:
            self._families.clear()
            self._phase = "startup"
            self._phase_ts = time.time()
            self._phase_history.clear()


class Watchdog:
    """Stall detector for blocking control-plane operations.

    The timeout is read from ``SMP_WATCHDOG_TIMEOUT`` at *call* time (not
    import time), so tests and long-running jobs can arm/disarm it without
    reimporting. Two usage shapes:

    - ``with watchdog.guard("barrier/step"):`` — a timer thread dumps the
      diagnostics if the block outlives the timeout (the block itself keeps
      waiting: device syncs are not interruptible from Python);
    - ``watchdog.wait(poll_fn, "recv/peer3")`` — polls until ``poll_fn()``
      is truthy; on timeout dumps AND raises ``SMPWatchdogTimeout``.

    """

    def __init__(self, registry):
        self._registry = registry
        self._dump_lock = threading.Lock()

    # -- configuration --------------------------------------------------

    def timeout(self):
        """Configured timeout in seconds, or None when disabled."""
        raw = os.environ.get(WATCHDOG_TIMEOUT_ENV, "")
        if not raw:
            return None
        try:
            t = float(raw)
        except ValueError:
            logger.warning(
                "invalid %s=%r (want seconds); watchdog disabled.",
                WATCHDOG_TIMEOUT_ENV, raw,
            )
            return None
        return t if t > 0 else None

    @property
    def enabled(self):
        return self.timeout() is not None

    # -- diagnostics ----------------------------------------------------

    def dump(self, reason, phase=None):
        """Snapshot registry + phase + all thread stacks to stderr and the
        SMP_WATCHDOG_PATH JSON file. Never raises (a broken dump must not
        mask the stall it is reporting). Returns the dump dict."""
        with self._dump_lock:
            try:
                # Mark the stall in the ring first: the snapshot below then
                # carries it, and later dumps show this one as history.
                try:
                    _flight().record_watchdog(reason)
                except Exception:
                    pass
                stacks = {}
                frames = sys._current_frames()
                names = {t.ident: t.name for t in threading.enumerate()}
                for tid, frame in frames.items():
                    stacks[f"{names.get(tid, '?')}:{tid}"] = (
                        traceback.format_stack(frame)
                    )
                payload = {
                    "reason": reason,
                    "phase": phase or self._registry.phase,
                    "time": time.time(),
                    "pid": os.getpid(),
                    "threads": stacks,
                    "telemetry": self._registry.report(),
                    # The last ~N structured events (collectives with seq
                    # numbers, schedule slots, phases): what this rank was
                    # DOING, not just where its threads are parked.
                    "flight_recorder": _flight_snapshot(),
                    # Wall-clock attribution at the stall: the current
                    # goodput state, per-state seconds, and the last N
                    # state TRANSITIONS — strictly more than the phase
                    # string (the 64-entry _phase_history only shows
                    # phases, not where the seconds went). None when the
                    # ledger is disarmed. Marking the stall first means
                    # the wedged seconds start accruing from the dump.
                    "goodput": _goodput_snapshot(reason),
                }
                path = self._registry._rank_path(
                    os.environ.get(WATCHDOG_PATH_ENV, "smp_watchdog_dump.json")
                )
                path = _atomic_json_dump(payload, path, "watchdog dump")
                sys.stderr.write(
                    "\n=== SMP WATCHDOG: %s (phase=%s) ===\n"
                    "full dump: %s\n" % (reason, payload["phase"], path)
                )
                for tname, stack in stacks.items():
                    sys.stderr.write(f"--- thread {tname} ---\n")
                    sys.stderr.write("".join(stack[-6:]))
                sys.stderr.flush()
                return payload
            except Exception:  # pragma: no cover - diagnostics must not throw
                return None

    # -- guards ---------------------------------------------------------

    class _Guard:
        def __init__(self, watchdog, phase, timeout):
            self._watchdog = watchdog
            self._phase = phase
            self._timeout = timeout
            self._timer = None
            self.fired = False

        def __enter__(self):
            if self._timeout is not None:
                self._timer = threading.Timer(self._timeout, self._on_stall)
                self._timer.daemon = True
                self._timer.start()
            return self

        def _on_stall(self):
            self.fired = True
            self._watchdog.dump(
                f"operation exceeded {self._timeout}s", phase=self._phase
            )

        def __exit__(self, *exc):
            if self._timer is not None:
                self._timer.cancel()
            return False

    def guard(self, phase):
        """Context manager: dump diagnostics if the body outlives the
        configured timeout. No-op (no timer thread) when disabled."""
        return self._Guard(self, phase, self.timeout())

    def wait(self, poll, phase, interval=0.05, timeout=None):
        """Poll ``poll()`` until truthy. On watchdog timeout: dump + raise
        ``SMPWatchdogTimeout``. With the watchdog disabled (and no explicit
        ``timeout``), polls forever — matching the unguarded behavior."""
        limit = timeout if timeout is not None else self.timeout()
        deadline = None if limit is None else time.monotonic() + limit
        while True:
            result = poll()
            if result:
                return result
            if deadline is not None and time.monotonic() >= deadline:
                self.dump(f"wait exceeded {limit}s", phase=phase)
                raise SMPWatchdogTimeout(
                    f"watchdog: {phase} stalled for more than {limit}s "
                    "(diagnostics dumped; see stderr / "
                    f"{os.environ.get(WATCHDOG_PATH_ENV, 'smp_watchdog_dump.json')})."
                )
            time.sleep(interval)


# ----------------------------------------------------------------------
# Singletons + convenience recorders
# ----------------------------------------------------------------------

telemetry = TelemetryRegistry()
watchdog = Watchdog(telemetry)

# Lazy seam to utils/flight_recorder.py (it imports THIS module for
# _rank_path, so the reverse edge must not exist at import time). The
# recorder-disabled case stays near-free: one module-attr lookup + the
# recorder's own `enabled` test.
_flight_mod = None


def _flight():
    global _flight_mod
    if _flight_mod is None:
        from smdistributed_modelparallel_tpu_torch.utils import flight_recorder

        _flight_mod = flight_recorder
    return _flight_mod.flight_recorder


def _flight_snapshot():
    try:
        fr = _flight()
        return {"meta": fr._meta(), "events": fr.snapshot()}
    except Exception:  # pragma: no cover - diagnostics must not throw
        return None


def _goodput_snapshot(reason):
    """The goodput-ledger block for a watchdog stall dump, or None when
    the ledger is disarmed. Lazy import: telemetry stays the leaf of the
    observability import graph."""
    try:
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        if goodput.ledger is None:
            return None
        # From the dump on, the stalled seconds accrue to `wedged`.
        goodput.mark_stalled(reason)
        return goodput.snapshot()
    except Exception:  # pragma: no cover - diagnostics must not throw
        return None


def record_pipeline_occupancy(schedule, num_stages, num_microbatches,
                              busy_slots, total_slots, virtual=1,
                              passes=2, pass_ticks=None):
    """Record measured schedule occupancy -> bubble fraction gauges.

    ``busy_slots``/``total_slots`` count (tick, stage[, sub-step]) slots of
    the static schedule the stage executors walk, tick by tick; the
    theoretical bound is ``(pp-1)/(mb+pp-1)`` for the plain schedules and
    the interleaved ``(pp-1)/(v*mb+pp-1)`` when ``virtual > 1`` (each rank
    owns ``v`` model chunks, so a schedule slot is a chunk sub-step and
    the fill/drain ramps shrink by ``v``). Zero-bubble schedules pass
    ``passes=3`` (forward / input-grad / weight-grad sub-steps): a slot
    is then a (chunk, microbatch, pass) unit and the bound drops to
    ``2*(pp-1)/(3*v*mb + 2*(pp-1))`` — the deferred weight-grad pass
    packs gapless, leaving only the F and B ramps as bubble. Gauges (not
    counters): every step sets them again, to the same values.

    ``pass_ticks`` (optional): {pass name: executed tick-span length}.
    Emitted as ``smp_pipeline_phase_ticks{phase="executed", pass=...}``
    — the per-pass denominators behind ``measured``, so the
    measured-vs-theoretical gate can audit a 3-pass schedule's occupancy
    accounting the same way the interleaved phase split is audited.
    """
    measured = 1.0 - (busy_slots / total_slots) if total_slots else 0.0
    if passes >= 3:
        denom = 3 * virtual * num_microbatches + 2 * (num_stages - 1)
        theoretical = 2 * (num_stages - 1) / denom if denom > 0 else 0.0
    else:
        denom = virtual * num_microbatches + num_stages - 1
        theoretical = (num_stages - 1) / denom if denom > 0 else 0.0
    lab = dict(schedule=schedule)
    if pass_ticks:
        phase_gauge = telemetry.gauge(
            "smp_pipeline_phase_ticks",
            "ticks per schedule phase (warmup/steady/cooldown) or per "
            "executed pass span (pass label)",
        )
        for pass_name, ticks in pass_ticks.items():
            phase_gauge.labels(
                phase="executed", schedule=schedule, **{"pass": pass_name}
            ).set(ticks)
    telemetry.gauge(
        "smp_pipeline_bubble_fraction",
        "measured idle fraction of pipeline schedule slots",
    ).labels(**lab).set(measured)
    telemetry.gauge(
        "smp_pipeline_bubble_fraction_theoretical",
        "schedule bound (pp-1)/(v*mb+pp-1); v=1 is the fill-drain bound",
    ).labels(**lab).set(theoretical)
    telemetry.gauge(
        "smp_pipeline_virtual_stages",
        "virtual pipeline chunks per stage (1 = no interleaving)",
    ).labels(**lab).set(virtual)
    telemetry.gauge(
        "smp_pipeline_schedule_slots", "slots in the static schedule"
    ).labels(state="busy", **lab).set(busy_slots)
    telemetry.gauge(
        "smp_pipeline_schedule_slots", "slots in the static schedule"
    ).labels(state="total", **lab).set(total_slots)
    telemetry.gauge(
        "smp_pipeline_stages", "pipeline stage count"
    ).labels(**lab).set(num_stages)
    telemetry.gauge(
        "smp_pipeline_microbatches", "microbatch count"
    ).labels(**lab).set(num_microbatches)
    return measured


def record_loss_scale(event, scale):
    """One fp16 loss-scale event ("overflow" | "growth" | "static_overflow"):
    counter + current-scale gauge + a flight-recorder health event — the
    scaler's backoff history becomes part of every post-mortem."""
    telemetry.counter(
        "smp_loss_scale_events_total", "fp16 loss-scale events by kind"
    ).labels(event=event).inc()
    telemetry.gauge(
        "smp_loss_scale", "current fp16 loss scale"
    ).set(float(scale))
    _flight().record_health("loss_scale", event, value=float(scale))


def record_update_stats(grad_norm, param_norm, update_norm):
    """Optimizer-step norm gauges (health modes only; see utils/health.py).
    ``update_ratio`` is ||new - old|| / ||new|| — the classic silent-LR
    pathology signal (~1e-3 healthy; ~1 = divergence, ~0 = frozen)."""
    if grad_norm is not None:
        telemetry.gauge(
            "smp_grad_norm", "global L2 norm of the last consumed gradients"
        ).set(grad_norm)
    telemetry.gauge(
        "smp_param_norm", "global L2 norm of the parameters after the update"
    ).set(param_norm)
    if update_norm is not None:
        telemetry.gauge(
            "smp_update_norm", "global L2 norm of the last parameter update"
        ).set(update_norm)
        telemetry.gauge(
            "smp_update_ratio",
            "update-to-parameter norm ratio of the last optimizer step",
        ).set(update_norm / (param_norm + 1e-12))


def record_health_check(step, tags):
    """One decoded health word: per-tag gauges + the checks counter."""
    telemetry.counter(
        "smp_health_checks_total", "health words decoded"
    ).inc()
    telemetry.gauge(
        "smp_health_last_checked_step", "most recent step whose word was read"
    ).set(step)
    for name, d in tags.items():
        telemetry.gauge(
            "smp_health_bad_count", "non-finite elements per sentinel tag"
        ).labels(tag=name).set(d["bad"])
        telemetry.gauge(
            "smp_health_absmax", "largest finite magnitude per sentinel tag"
        ).labels(tag=name).set(d["absmax"])
        telemetry.gauge(
            "smp_health_first_microbatch",
            "first microbatch with a non-finite value (-1 = none)",
        ).labels(tag=name).set(d["microbatch"])


def record_health_trip(tag, step, bad, absmax, microbatch):
    telemetry.counter(
        "smp_health_trips_total", "tripped sentinel tags"
    ).labels(tag=tag).inc()
    telemetry.gauge(
        "smp_health_last_trip_step", "step of the most recent sentinel trip"
    ).set(step)
    _flight().record_health(
        "trip", tag, step=step, value=bad, microbatch=microbatch
    )


def record_health_fault(layer, microbatch, tag, step):
    """Bisection attribution: the first non-finite value's layer."""
    telemetry.counter(
        "smp_health_fault_total",
        "bisection fault attributions (layer of the first non-finite value)",
    ).labels(layer=str(layer), microbatch=str(microbatch), tag=tag).inc()
    _flight().record_health(
        "fault", str(layer), step=step, microbatch=microbatch
    )


def record_oom(name):
    telemetry.counter(
        "smp_oom_total", "RESOURCE_EXHAUSTED failures with a post-mortem dump"
    ).labels(step=str(name)).inc()
    _flight().record_health("oom", str(name))


def record_preemption(event, step=-1, detail=""):
    """Preemption lifecycle (resilience/preemption.py): ``requested`` when
    the signal/sentinel fires, ``rendezvous``/``saved``/``failed`` along
    the emergency-checkpoint path."""
    telemetry.counter(
        "smp_preemption_total", "preemption lifecycle events"
    ).labels(event=event).inc()
    _flight().record_preempt(event, step=step, detail=detail)


def record_sync_mark(name, group, seq):
    """One barrier-exit sync mark: the flight recorder's cross-rank clock
    alignment point (``scripts/trace_fuse.py``) and the skew gauges. The
    members of a group leave a barrier within network jitter of each
    other, so ``smp_sync_last_unix_seconds`` at one ``smp_sync_seq``
    compared across the ranks' dumps measures their wall-clock skew."""
    _flight().record_sync(name, group, seq)
    telemetry.counter("smp_sync_marks_total", "barrier sync marks recorded").labels(group=group).inc()
    telemetry.gauge("smp_sync_seq", "per-group barrier ordinal of the last sync mark").labels(group=group).set(seq)
    telemetry.gauge(
        "smp_sync_last_unix_seconds", "wall-clock time of the last barrier exit (cross-rank skew probe)",
    ).labels(group=group).set(time.time())


def record_comm(op, group, nbytes, group_size):
    """One host-collective record: op count, payload bytes, group size.
    Symmetric ops (broadcast, allgather, barrier) take the group's ring
    sequence number; point-to-point streams are recorded unsequenced."""
    g = getattr(group, "name", None) or str(group)
    _flight().record_collective(op, g, nbytes, group_size, sequenced=op in ("broadcast", "allgather", "barrier"))
    telemetry.counter("smp_comm_ops_total", "host collective operations").labels(op=op, group=g).inc()
    if nbytes:
        telemetry.counter("smp_comm_bytes_total", "host collective payload bytes").labels(op=op, group=g).inc(
            int(nbytes))
    telemetry.gauge(
        "smp_comm_group_size", "process count of the last collective per op/group",
    ).labels(op=op, group=g).set(int(group_size))


def record_chaos(fault, detail=""):
    """One injected fault (resilience/chaos.py) — counted and ring-recorded
    so a post-mortem always shows which failures were synthetic."""
    telemetry.counter(
        "smp_chaos_injected_total", "chaos faults injected"
    ).labels(fault=fault).inc()
    _flight().record_chaos(fault, detail)


def record_failure_detected(kind, peer, detail=""):
    """One failure-detector classification (resilience/supervisor.py):
    ``kind`` is dead / wedged / preempted (or flap_cleared when a peer
    marked dead resumed beating before recovery began)."""
    telemetry.counter(
        "smp_failures_detected_total",
        "peer failures classified by the heartbeat detector",
    ).labels(kind=kind).inc()
    _flight().record_supervisor(f"detect_{kind}", peer=peer, detail=detail)


def record_recovery(mttr_s, phases=None, survivors=-1):
    """One completed in-job recovery (resilience/supervisor.py):
    ``mttr_s`` spans detection to the first trained step in the shrunken
    world; ``phases`` optionally breaks it down (detect / rendezvous /
    reshard_load / first_step seconds)."""
    telemetry.counter(
        "smp_recoveries_total", "completed in-job shrink-to-survivors recoveries"
    ).inc()
    telemetry.gauge(
        "smp_recovery_seconds",
        "MTTR of the last recovery (detection -> first step trained)",
    ).set(float(mttr_s))
    if survivors >= 0:
        telemetry.gauge(
            "smp_recovery_survivors", "world size after the last recovery"
        ).set(int(survivors))
    for phase, secs in (phases or {}).items():
        telemetry.gauge(
            "smp_recovery_phase_seconds",
            "per-phase breakdown of the last recovery",
        ).labels(phase=phase).set(float(secs))
    _flight().record_supervisor(
        "recovery_done",
        detail=f"mttr={mttr_s:.3f}s " + " ".join(
            f"{k}={v:.3f}" for k, v in (phases or {}).items()
        ),
    )


def record_elastic_resume(n_layout, n_soft, detail=""):
    """One elastic (topology-mismatched) checkpoint resume
    (resilience/elastic.py): counts of layout-relevant and soft config
    mismatches that were downgraded from fatal to a reshard."""
    telemetry.counter(
        "smp_elastic_resume_total", "elastic reshard-on-resume events"
    ).inc()
    telemetry.gauge(
        "smp_elastic_resume_mismatches",
        "config mismatches downgraded by the last elastic resume",
    ).labels(kind="layout").set(n_layout)
    telemetry.gauge(
        "smp_elastic_resume_mismatches",
        "config mismatches downgraded by the last elastic resume",
    ).labels(kind="soft").set(n_soft)
    _flight().record_preempt("elastic_resume", detail=detail)


def record_fused_kernel_dispatch(kernel, path):
    """One fused-kernel dispatch decision (``qkv`` / ``bias_gelu``; path
    ``pallas`` — the hand-written kernel — or ``fallback``), the hit
    counters the tp-overlap report section renders. Counted as the JAX
    package counts its trace-time decisions: per compiled program, not per
    executed step (``model.replay_program_ticks``)."""
    telemetry.counter(
        "smp_fused_kernel_dispatch_total",
        "fused-kernel dispatch decisions at trace time by kernel and "
        "chosen path",
    ).labels(kernel=kernel, path=path).inc()


def record_serve_request(event, n=1):
    """One serving-request lifecycle event (serving/engine.py):
    ``admitted`` / ``finished`` / ``readmitted`` (failover re-admission of
    a dead replica's in-flight request) / ``deadline_miss``."""
    telemetry.counter(
        "smp_serve_requests_total", "serving requests by lifecycle event"
    ).labels(event=event).inc(n)


def record_serve_tokens(kind, n):
    """Serving token throughput counter: ``kind`` is prompt (prefilled)
    or generated (sampled)."""
    if n:
        telemetry.counter(
            "smp_serve_tokens_total", "serving tokens by kind"
        ).labels(kind=kind).inc(int(n))


_SERVE_LATENCY_HELP = {
    "ttft": "time to first token (arrival -> first sampled token)",
    "itl": "inter-token latency of decode streams",
    "queue_wait": "queue wait (arrival -> decode-slot admission)",
    "prefill": "prompt prefill wall (admission -> first token sampled)",
    "decode_step": "batched decode-step dispatch wall",
}


def record_serve_latency(kind, seconds):
    """One serving latency sample, ``kind`` in SERVE_LATENCY_KINDS.

    Feeds the streaming log-bucketed histogram
    ``smp_serve_latency_seconds{kind=...}`` (fixed memory, mergeable
    across ranks — ``scripts/telemetry_report.py`` sums bucket counts
    element-wise because every rank uses the same LATENCY_BUCKETS tuple)
    and derives the per-kind gauge family
    ``smp_serve_<kind>_seconds{stat=last|mean|p50|p90|p99}``. The
    ``last``/``mean`` stats keep the pre-histogram names and meanings
    (mean is the histogram's lifetime sum/count), so existing dashboards
    keep reading the same series."""
    v = float(seconds)
    child = telemetry.histogram(
        "smp_serve_latency_seconds",
        "serving latency distributions by kind (the log-bucketed "
        "streaming histogram behind the percentile gauges)",
        buckets=LATENCY_BUCKETS,
    ).labels(kind=kind)
    child.observe(v)
    snap = child._snapshot()
    g = telemetry.gauge(
        f"smp_serve_{kind}_seconds",
        _SERVE_LATENCY_HELP.get(kind, "serving latency"),
    )
    g.labels(stat="last").set(v)
    g.labels(stat="mean").set(snap["sum"] / max(snap["count"], 1))
    for stat, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
        est = quantile_from_counts(snap["buckets"], snap["counts"], q)
        if est is not None:
            g.labels(stat=stat).set(est)


def serve_latency_summary(kind, qs=(0.5, 0.9, 0.99)):
    """``{"count", "mean_s", "quantiles_s": {q: seconds}}`` of one
    serving latency distribution, or None before its first sample
    (bench.py stamps the serve probe's percentile columns from this)."""
    with telemetry._lock:
        fam = telemetry._families.get("smp_serve_latency_seconds")
    if fam is None:
        return None
    snap = fam.labels(kind=kind)._snapshot()
    if not snap["count"]:
        return None
    return {
        "count": snap["count"],
        "mean_s": snap["sum"] / snap["count"],
        "quantiles_s": {
            q: quantile_from_counts(snap["buckets"], snap["counts"], q)
            for q in qs
        },
    }


def record_step_time(seconds):
    """One training-step wall-time sample into the log-bucketed step-time
    histogram ``smp_step_time_seconds`` plus p50/p90/p99 gauges — the
    training-path counterpart of the serving latency distributions (a
    p99 step blowup is invisible in the dispatch-seconds mean)."""
    v = float(seconds)
    child = telemetry.histogram(
        "smp_step_time_seconds",
        "per-step dispatch wall-time distribution (log-bucketed)",
        buckets=LATENCY_BUCKETS,
    ).labels()
    child.observe(v)
    snap = child._snapshot()
    g = telemetry.gauge(
        "smp_step_time_quantile_seconds",
        "step wall-time percentiles from the streaming histogram",
    )
    for stat, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
        est = quantile_from_counts(snap["buckets"], snap["counts"], q)
        if est is not None:
            g.labels(stat=stat).set(est)


def record_serve_trace(event, rid, trace=None, slot=-1, pos=-1, detail=""):
    """One per-request serving span edge (``queued`` / ``admitted`` /
    ``readmitted`` / ``prefill_chunk`` / ``first_token`` / ``finished``)
    into the flight-recorder ring. Host-side timestamps only — recording
    costs one perf_counter read and a deque append, and a disabled ring
    (``SMP_FLIGHT_RECORDER_SIZE=0``) short-circuits to an attribute
    test. ``scripts/trace_fuse.py`` pairs the edges into one Perfetto
    span lane per decode slot; the trace id rides the failover mirror
    log, so a re-admitted request continues its original trace on the
    surviving replica."""
    _flight().record_serve(
        event, rid, trace=trace, slot=slot, pos=pos, detail=detail
    )


def record_serve_occupancy(queue_depth, active_slots, total_slots,
                           kv_used, kv_free, kv_reserved, kv_total,
                           block_bytes=None):
    """Continuous-batching occupancy gauges: request queue depth, decode
    slots in use, and KV-pool block accounting (used / free / promised-
    but-unallocated reservations / total). ``block_bytes`` (bytes per
    pool block AT THE POOL DTYPE, scale sidecars included) additionally
    publishes the block counts as ``smp_serve_kv_bytes`` — the gauge
    that makes the int8-KV halving claim checkable against the bf16
    pool rather than inferred from dtype names."""
    telemetry.gauge(
        "smp_serve_queue_depth", "requests waiting for a decode slot"
    ).set(int(queue_depth))
    g_slots = telemetry.gauge(
        "smp_serve_slots", "decode slots by state"
    )
    g_slots.labels(state="active").set(int(active_slots))
    g_slots.labels(state="total").set(int(total_slots))
    g_kv = telemetry.gauge(
        "smp_serve_kv_blocks", "paged KV-pool blocks by state"
    )
    g_kv.labels(state="used").set(int(kv_used))
    g_kv.labels(state="free").set(int(kv_free))
    g_kv.labels(state="reserved").set(int(kv_reserved))
    g_kv.labels(state="total").set(int(kv_total))
    if block_bytes is not None:
        g_b = telemetry.gauge(
            "smp_serve_kv_bytes",
            "paged KV-pool bytes by state (blocks x bytes per block at "
            "the pool dtype, including quantization-scale sidecars)",
        )
        g_b.labels(state="used").set(int(kv_used) * int(block_bytes))
        g_b.labels(state="free").set(int(kv_free) * int(block_bytes))
        g_b.labels(state="reserved").set(
            int(kv_reserved) * int(block_bytes)
        )
        g_b.labels(state="total").set(int(kv_total) * int(block_bytes))


def record_quant_state(slots, amax, scale):
    """Latest delayed-scaling statistics per quantization slot
    (``quant.QuantState.absorb`` after each fp8 step): the newest amax
    observation and the dequantization scale now in force."""
    g_a = telemetry.gauge(
        "smp_quant_amax",
        "latest per-slot amax observation of the fp8 delayed-scaling "
        "recipe",
    )
    g_s = telemetry.gauge(
        "smp_quant_scale",
        "per-slot fp8 dequantization scale currently in force",
    )
    for slot, a, s in zip(slots, amax, scale):
        g_a.labels(site=slot).set(float(a))
        g_s.labels(site=slot).set(float(s))


def record_quant_dispatch(site, path):
    """One low-precision dispatch decision at trace/setup time: a seam
    routed through fp8 (``path=fp8``), a knob canonicalized back to
    bf16 (``path=bf16_fallback``), the KV pool went int8
    (``site=kv_cache``), or decode weights were repacked
    (``site=decode_weights``). Counts are per-trace, not per-step —
    the signal is WHICH paths engaged, mirroring the fused-kernel
    dispatch counter."""
    telemetry.counter(
        "smp_quant_dispatch_total",
        "low-precision dispatch decisions by seam and path",
    ).labels(site=site, path=path).inc()


def record_serve_programs(n):
    telemetry.gauge(
        "smp_serve_programs",
        "compiled serving programs (the engine holds exactly two: "
        "prefill-chunk and decode-step)",
    ).set(int(n))


def record_scale_event(direction, seconds, phases=None, replicas=None):
    """One completed autoscale event (serving/controller.py): ``up``
    grew the replica set (rendezvous + exec-cache warm start),
    ``down`` shrank it through the drain protocol. ``phases`` breaks
    the wall down like a recovery MTTR (trigger / rendezvous /
    warm_start / first_token for up; drain / reroute for down)."""
    telemetry.counter(
        "smp_autoscale_events_total",
        "completed autoscale events by direction",
    ).labels(direction=direction).inc()
    telemetry.gauge(
        "smp_autoscale_last_scale_seconds",
        "wall seconds of the last autoscale event (trigger -> serving)",
    ).set(float(seconds))
    for phase, secs in (phases or {}).items():
        telemetry.gauge(
            "smp_autoscale_phase_seconds",
            "per-phase breakdown of the last autoscale event",
        ).labels(phase=phase).set(float(secs))
    if replicas is not None:
        telemetry.gauge(
            "smp_controller_replicas",
            "live serving replicas the controller routes to",
        ).set(int(replicas))
    _flight().record_controller(
        f"scale_{direction}",
        detail=f"seconds={seconds:.3f} " + " ".join(
            f"{k}={v:.3f}" for k, v in (phases or {}).items()
        ),
    )


def record_controller_replicas(n):
    """Live replica-count gauge outside a scale event (controller
    construction, replica death absorbed by failover, shutdown)."""
    telemetry.gauge(
        "smp_controller_replicas",
        "live serving replicas the controller routes to",
    ).set(int(n))


def record_route(version, n=1):
    """One request dispatched by the front-door router
    (serving/router.py), labelled with the weights version of the
    replica it landed on (the blue/green traffic-split evidence)."""
    telemetry.counter(
        "smp_controller_routed_total",
        "requests dispatched by the router, by weights version",
    ).labels(version=str(version)).inc(n)


def record_drain_stragglers(n):
    """Queued-but-never-admitted requests handed back by a draining
    replica and re-routed elsewhere (zero dropped tokens: every
    straggler is re-admitted from its restartable record)."""
    if n:
        telemetry.counter(
            "smp_controller_drain_stragglers_total",
            "requests re-routed off draining replicas",
        ).inc(int(n))


def record_canary(verdict, version, detail=""):
    """A blue/green canary verdict (serving/controller.py):
    ``promoted`` (token parity held and the SLO-window comparison
    passed — every replica adopts), ``rolled_back`` (parity mismatch or
    SLO regression — traffic snaps back, the counter latches), or
    ``started``."""
    if verdict == "promoted":
        telemetry.counter(
            "smp_canary_promotions_total",
            "canary versions promoted to the full replica set",
        ).inc()
    elif verdict == "rolled_back":
        telemetry.counter(
            "smp_canary_rollback_total",
            "canary versions rolled back (token-parity mismatch or "
            "SLO regression)",
        ).inc()
    telemetry.gauge(
        "smp_canary_active",
        "1 while a canary version is taking split traffic",
    ).set(1 if verdict == "started" else 0)
    _flight().record_controller(
        f"canary_{verdict}", detail=f"version={version} {detail}".strip()
    )


def record_weight_update(seconds, version, fresh=0):
    """One live weight adoption (serving/engine.py ``adopt_params``):
    ``seconds`` is the full swap wall, ``fresh`` the number of fresh
    program compiles it caused — the zero-recompile contract holds
    when it stays 0 (exec-cache keys are weight-free)."""
    telemetry.gauge(
        "smp_weight_update_seconds",
        "wall seconds of the last live weight adoption (zero-recompile "
        "contract: no compile_fresh events inside this window)",
    ).set(float(seconds))
    telemetry.counter(
        "smp_weight_updates_total", "live weight adoptions by outcome"
    ).labels(outcome="adopted" if not fresh else "recompiled").inc()
    telemetry.gauge(
        "smp_controller_weights_version",
        "weights version this engine currently serves",
    ).set(int(version))
    _flight().record_controller(
        "weight_update",
        detail=f"version={version} seconds={seconds:.3f} fresh={fresh}",
    )


def _atexit_dump():  # pragma: no cover - exercised via subprocess test
    try:
        # An empty registry must not clobber the dump smp.shutdown already
        # wrote (shutdown resets the registry after dumping).
        if telemetry._families:
            telemetry.dump()
    except Exception:
        pass


atexit.register(_atexit_dump)
