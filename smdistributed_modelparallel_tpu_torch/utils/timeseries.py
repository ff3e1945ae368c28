"""Serving metrics time-series + SLO evaluation (the autoscaler feed).

Counterpart of ``smdistributed_modelparallel_tpu/utils/timeseries.py``: the
same windows, SLO keys, env vars, gauges and JSONL records, so
``scripts/slo_report.py`` reads either package's feed.

The serving gauges are instantaneous (queue depth, occupancy) or
lifetime (request/token counters, latency means) — neither is what a
control loop wants. ``MetricsTimeSeries`` snapshots the registry at a
fixed interval (``SMP_TIMESERIES_INTERVAL`` seconds; unset/0 disables
the subsystem entirely — no ring, no thread) and turns each window into
one bounded record:

- counter DELTAS over the window (requests admitted/finished, tokens),
  and windowed rates (req/s, tok/s, tok/s/chip) — a burst shows up at
  its real rate instead of being averaged into idle history the way the
  old lifetime rates were;
- WINDOW latency percentiles: the streaming log-bucketed histograms in
  ``utils/telemetry.py`` are cumulative, so subtracting the previous
  window's bucket counts yields the distribution of just this window —
  fixed memory, no per-sample storage;
- the SLO verdict: ``SMP_SLO="ttft_p99_ms=500,itl_p99_ms=50,
  queue_depth=8"`` is evaluated against each window; violations bump
  ``smp_slo_violations_total{slo=...}`` and the running goodput fraction
  (windows with zero violations / windows) lands in
  ``smp_slo_goodput_fraction``.

Windows live in a bounded ring (``SMP_TIMESERIES_SIZE``) and are
appended live as JSONL when ``SMP_TIMESERIES_PATH`` is set (rank-
qualified like every other dump) — the exact stream
``scripts/slo_report.py`` reads and ``--check`` gates on.

Sampling is driven two ways at once: the engine polls
``maybe_sample()`` from its tick path (sharp window edges while busy)
and a daemon thread covers idle gaps — both go through one lock and the
interval gate, so a window is taken exactly once. Everything here is
host-side registry arithmetic: no device sync.
"""

import collections
import json
import os
import threading
import time

from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPValidationError,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    SERVE_LATENCY_KINDS,
    quantile_from_counts,
    telemetry,
)

logger = get_logger()

TIMESERIES_INTERVAL_ENV = "SMP_TIMESERIES_INTERVAL"
TIMESERIES_PATH_ENV = "SMP_TIMESERIES_PATH"
TIMESERIES_SIZE_ENV = "SMP_TIMESERIES_SIZE"
SLO_ENV = "SMP_SLO"

DEFAULT_SIZE = 512

#: Keys an SMP_SLO spec may bound. ``*_ms`` keys and ``queue_depth`` are
#: upper bounds on the matching window field; ``*_min`` keys are lower
#: bounds (throughput floors).
SLO_KEYS = tuple(
    f"{kind}_{stat}_ms"
    for kind in SERVE_LATENCY_KINDS
    for stat in ("p50", "p90", "p99", "mean")
) + ("queue_depth", "tokens_per_s_min", "requests_per_s_min")


def timeseries_interval():
    """Window length in seconds; 0.0 means the subsystem is disabled."""
    raw = os.environ.get(TIMESERIES_INTERVAL_ENV, "")
    if not raw:
        return 0.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        logger.warning(
            "invalid %s=%r (want seconds); time-series disabled.",
            TIMESERIES_INTERVAL_ENV, raw,
        )
        return 0.0


def _env_size():
    raw = os.environ.get(TIMESERIES_SIZE_ENV, "")
    if not raw:
        return DEFAULT_SIZE
    try:
        return max(int(raw), 1)
    except ValueError:
        logger.warning(
            "invalid %s=%r (want an integer); using default %d.",
            TIMESERIES_SIZE_ENV, raw, DEFAULT_SIZE,
        )
        return DEFAULT_SIZE


def parse_slo(spec):
    """Parse an ``SMP_SLO`` spec ("ttft_p99_ms=500,itl_p99_ms=50,
    queue_depth=8") into ``{key: threshold}``. Unknown keys raise — a
    typo'd SLO that silently never violates is worse than failing
    fast."""
    out = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, raw = part.partition("=")
        key = key.strip()
        if not sep:
            raise SMPValidationError(
                f"SLO term {part!r} lacks '=<threshold>'."
            )
        if key not in SLO_KEYS:
            raise SMPValidationError(
                f"unknown SLO key {key!r}; supported keys: "
                f"{', '.join(SLO_KEYS)}."
            )
        try:
            out[key] = float(raw)
        except ValueError:
            raise SMPValidationError(
                f"SLO threshold {raw!r} for {key!r} is not a number."
            )
    return out


def evaluate_slo(slo, window):
    """Evaluate one parsed SLO spec against one window record. A key the
    window has no value for (no samples of that kind this window) is NOT
    a violation — an idle window meets every latency SLO."""
    violations = {}
    for key in sorted(slo):
        limit = slo[key]
        if key.endswith("_min"):
            value = window.get(key[: -len("_min")])
            bad = value is not None and value < limit
        else:
            value = window.get(key)
            bad = value is not None and value > limit
        if bad:
            violations[key] = {"limit": limit, "value": value}
    return {"ok": not violations, "violations": violations}


def _goodput_block():
    """The armed goodput ledger's per-window fold, or None. Lazy lookup:
    the ledger is optional and this module must not construct it."""
    try:
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        return goodput.window_block()
    except Exception:
        return None


def _trigger_forensics(reason, detail):
    try:
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        goodput.trigger_forensics(reason, detail=detail)
    except Exception:
        logger.warning("forensics trigger (%s) failed", reason,
                       exc_info=True)


class MetricsTimeSeries:
    """Bounded fixed-interval snapshotter of the serving metrics."""

    THREAD_NAME = "smp-timeseries"

    def __init__(self, registry=None, interval=None, size=None, path=None,
                 slo=None, chips=1, clock=None, wall=None):
        self.registry = registry if registry is not None else telemetry
        self.interval = (
            timeseries_interval() if interval is None
            else max(float(interval), 0.0)
        )
        self.enabled = self.interval > 0.0
        self.size = _env_size() if size is None else max(int(size), 1)
        self.path = (
            os.environ.get(TIMESERIES_PATH_ENV) if path is None else path
        ) or None
        if slo is None:
            raw = os.environ.get(SLO_ENV, "")
            try:
                self.slo = parse_slo(raw) if raw else {}
            except SMPValidationError as e:
                logger.warning("ignoring invalid %s: %s", SLO_ENV, e)
                self.slo = {}
        elif isinstance(slo, str):
            self.slo = parse_slo(slo)
        else:
            self.slo = dict(slo)
        self.chips = max(int(chips), 1)
        self._clock = clock or time.monotonic
        self._wall = wall or time.time
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.size)
        self._seq = 0
        self._ok_windows = 0
        self._slo_streak = 0
        self._t_start = self._clock()
        self._last_sample = self._t_start
        self._prev = self._read() if self.enabled else None
        self._stop_event = threading.Event()
        self._thread = None

    @classmethod
    def from_env(cls, registry=None, chips=1):
        """The env-configured snapshotter, or None when
        ``SMP_TIMESERIES_INTERVAL`` is unset/0 — in which case NOTHING is
        constructed: no ring, no baseline snapshot, no thread."""
        if timeseries_interval() <= 0.0:
            return None
        return cls(registry=registry, chips=chips)

    # -- registry reading ----------------------------------------------

    def _read(self):
        """One raw cumulative snapshot of the serving metrics (the
        subtrahend for the next window's deltas)."""
        metrics = self.registry.report().get("metrics", {})

        def series(name):
            fam = metrics.get(name)
            return fam["series"] if fam else []

        def value(name, **labels):
            for s in series(name):
                if all(s["labels"].get(k) == v for k, v in labels.items()):
                    return float(s.get("value", 0.0))
            return 0.0

        hists = {}
        for s in series("smp_serve_latency_seconds"):
            kind = s["labels"].get("kind")
            if kind:
                hists[kind] = (
                    list(s.get("buckets") or ()),
                    list(s.get("counts") or ()),
                    float(s.get("sum", 0.0)),
                    int(s.get("count", 0)),
                )
        return {
            "requests": {
                ev: value("smp_serve_requests_total", event=ev)
                for ev in ("admitted", "finished", "readmitted")
            },
            "tokens": {
                k: value("smp_serve_tokens_total", kind=k)
                for k in ("generated", "prompt")
            },
            "queue_depth": value("smp_serve_queue_depth"),
            "active_slots": value("smp_serve_slots", state="active"),
            "kv_used": value("smp_serve_kv_blocks", state="used"),
            "hists": hists,
        }

    # -- sampling -------------------------------------------------------

    def maybe_sample(self, now=None):
        """Take a window snapshot iff at least one interval has elapsed
        since the last one. Safe to call from the engine tick loop and
        the snapshotter thread concurrently."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        with self._lock:
            if now - self._last_sample < self.interval:
                return None
            return self._sample_locked(now)

    def sample(self, now=None):
        """Take one window snapshot unconditionally (end-of-run flushes
        and the fake-clock tests drive this directly)."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        with self._lock:
            return self._sample_locked(now)

    def _sample_locked(self, now):
        raw = self._read()
        prev = self._prev
        dt = max(now - self._last_sample, 1e-9)
        elapsed = max(now - self._t_start, 1e-9)
        self._seq += 1
        d_req = {
            k: raw["requests"][k] - prev["requests"].get(k, 0.0)
            for k in raw["requests"]
        }
        d_tok = {
            k: raw["tokens"][k] - prev["tokens"].get(k, 0.0)
            for k in raw["tokens"]
        }
        window = {
            "kind": "serve_window",
            "seq": self._seq,
            "t_wall": self._wall(),
            "window_s": dt,
            "queue_depth": raw["queue_depth"],
            "active_slots": raw["active_slots"],
            "kv_used_blocks": raw["kv_used"],
            "requests_admitted": d_req["admitted"],
            "requests_finished": d_req["finished"],
            "requests_readmitted": d_req["readmitted"],
            "tokens_generated": d_tok["generated"],
            "tokens_prompt": d_tok["prompt"],
            "requests_per_s": d_req["finished"] / dt,
            "tokens_per_s": d_tok["generated"] / dt,
            "tokens_per_s_chip": d_tok["generated"] / dt / self.chips,
            # Lifetime figures ride along so one JSONL line is enough to
            # see windowed-vs-lifetime divergence on a bursty trace.
            "lifetime_tokens_generated": raw["tokens"]["generated"],
            "lifetime_tokens_per_s": raw["tokens"]["generated"] / elapsed,
        }
        for kind, (buckets, counts, hsum, hcount) in raw["hists"].items():
            pb = prev["hists"].get(kind)
            if pb is not None and pb[0] == buckets:
                dcounts = [a - b for a, b in zip(counts, pb[1])]
                dsum, dn = hsum - pb[2], hcount - pb[3]
            else:
                dcounts, dsum, dn = counts, hsum, hcount
            if dn <= 0:
                continue
            window[f"{kind}_mean_ms"] = 1e3 * dsum / dn
            for stat, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                est = quantile_from_counts(buckets, dcounts, q)
                if est is not None:
                    window[f"{kind}_{stat}_ms"] = 1e3 * est
        # Satellite fix: the throughput gauges are now WINDOWED — the old
        # engine-lifetime averages decayed toward idle history and could
        # never show a burst. Lifetime totals remain as counters.
        self.registry.gauge(
            "smp_serve_requests_per_sec",
            "completed requests per second over the last time-series "
            "window",
        ).set(window["requests_per_s"])
        g_tok = self.registry.gauge(
            "smp_serve_tokens_per_sec",
            "generated tokens per second over the last time-series window",
        )
        g_tok.labels(scope="engine").set(window["tokens_per_s"])
        g_tok.labels(scope="chip").set(window["tokens_per_s_chip"])
        self.registry.gauge(
            "smp_timeseries_windows", "time-series window snapshots taken"
        ).set(self._seq)
        if self.slo:
            verdict = evaluate_slo(self.slo, window)
            if verdict["ok"]:
                self._ok_windows += 1
            verdict["goodput"] = self._ok_windows / self._seq
            for key in verdict["violations"]:
                self.registry.counter(
                    "smp_slo_violations_total",
                    "SLO violations by key (one per violating "
                    "time-series window)",
                ).labels(slo=key).inc()
            self.registry.gauge(
                "smp_slo_goodput_fraction",
                "fraction of time-series windows with zero SLO violations",
            ).set(verdict["goodput"])
            self.registry.gauge(
                "smp_slo_ok", "1 when the last window met every SLO"
            ).set(1.0 if verdict["ok"] else 0.0)
            window["slo"] = verdict
            # An SLO violation STREAK (not one bad window) is an
            # anomaly worth evidence: three consecutive violating
            # windows trigger one auto-forensics bundle (rate-limited
            # by the engine's own cooldown; no-op when disarmed).
            if verdict["ok"]:
                self._slo_streak = 0
            else:
                self._slo_streak += 1
                if self._slo_streak == 3:
                    _trigger_forensics(
                        "slo_streak",
                        f"3 consecutive violating windows: "
                        f"{sorted(verdict['violations'])}",
                    )
        gp = _goodput_block()
        if gp is not None:
            # Fold the wall-clock attribution into the window so one
            # JSONL line answers both "is serving meeting its SLO" and
            # "where did this rank's seconds go".
            window["train_goodput"] = gp["fraction"]
            if gp["badput"]:
                window["badput_seconds"] = gp["badput"]
        self._ring.append(window)
        self._append_jsonl(window)
        self._prev = raw
        self._last_sample = now
        return window

    def _append_jsonl(self, window):
        if not self.path:
            return
        path = self.registry._rank_path(self.path)
        try:
            with open(path, "a") as f:
                f.write(json.dumps(window) + "\n")
        except OSError as e:
            logger.warning(
                "time-series append to %s failed (%s); disabling the "
                "JSONL feed.", path, e,
            )
            self.path = None

    def snapshots(self):
        """The in-memory ring, oldest first."""
        with self._lock:
            return list(self._ring)

    # -- background thread ---------------------------------------------

    def start(self):
        """Start the idle-gap snapshotter thread. No-op when disabled
        (``SMP_TIMESERIES_INTERVAL=0`` must not cost a thread) or already
        running."""
        if not self.enabled or self._thread is not None:
            return None
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self.THREAD_NAME, daemon=True
        )
        self._thread.start()
        return self._thread

    def stop(self):
        """Stop the snapshotter thread. Idempotent."""
        thread = self._thread
        if thread is None:
            return
        self._stop_event.set()
        thread.join(timeout=5.0)
        self._thread = None

    def _loop(self):
        while not self._stop_event.wait(self.interval):
            try:
                self.maybe_sample()
            except Exception:  # pragma: no cover - must not die
                logger.exception("time-series sample failed")
