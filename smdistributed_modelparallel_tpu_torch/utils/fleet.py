"""Fleet metrics plane (``smp.fleet``) of the PyTorch port: one live,
fleet-level view of the N per-rank telemetry registries.

Counterpart of ``smdistributed_modelparallel_tpu/utils/fleet.py``, with the
same env vars, reserved tx id, metric names, JSONL records and scrape routes.
At world size 1 the plane runs with ``bus=None, world=1``: the rank
aggregates itself and sends nothing. At world > 1 it publishes over the host
bus ``state.bus`` (the native bus ``smp.init`` brings up), and runs over any
object with that bus's ``send_raw``/``drain_bytes``/``peer_down``
interface.

Three moving parts, all off by default:

- A **publisher** on every rank: each ``SMP_FLEET_INTERVAL`` seconds it
  serializes a compact snapshot of the local registry (counter totals,
  gauges, raw histogram bucket counts — no help strings) and pushes it
  to the current aggregator over the native bus on reserved control tx
  -7 (``FLEET_TX``), via the same quiet ``send_raw``/``drain_bytes``
  paths heartbeats use: no chaos seam, no flight-recording, no retries.
  A failed send is not an error — a dead link is next tick's election
  signal.

- An **aggregator** on the lowest-alive rank (re-elected through the
  supervisor's failure detector when it dies; a replica death must not
  kill the metrics plane). It merges snapshots exactly — counters
  summed, histograms by element-wise bucket-count addition (every rank
  shares the deterministic ``LATENCY_BUCKETS``), gauges kept per-rank
  with min/max/median skew stats — so fleet p50/p90/p99 are bit-equal
  to ``scripts/telemetry_report.py --dir`` offline-merging the same
  ranks' dumps. Each interval it evaluates ``SMP_SLO`` at FLEET level
  into fleet goodput and appends a ``fleet_window`` record to the
  ``SMP_FLEET_PATH`` JSONL — the autoscaler's input feed (deliberately
  NOT rank-qualified: only the one live aggregator writes it, and a
  successor appends to the same file so the feed survives failover).

- A **scrape endpoint** (stdlib ``http.server`` daemon thread on
  ``SMP_METRICS_PORT``): ``/metrics`` (per-rank Prometheus text) and
  ``/metrics.json`` everywhere; ``/fleet`` (merged JSON view with
  per-rank freshness) and ``/fleet/metrics`` (merged Prometheus text)
  answer on the aggregator and 404 — with a pointer to the aggregator
  rank — elsewhere.

On top of the merged view the aggregator runs three fleet detectors,
publishing ``smp_fleet_*`` gauges and flight-recorder ``fleet`` events
on transitions:

- **straggler**: a rank whose ITL (falling back to step-time) p99 sits
  above ``SMP_FLEET_STRAGGLER_RATIO`` x the fleet median of per-rank
  p99s (lower median — deterministic and conservative in 2-rank
  fleets).
- **kv imbalance**: max/mean of per-rank used KV-pool blocks above
  ``SMP_FLEET_KV_IMBALANCE_RATIO``.
- **stale feed**: a rank that stopped publishing for
  ``SMP_FLEET_STALE_WINDOWS`` intervals but still heartbeats —
  distinct from dead (dead ranks leave the merge; stale ranks stay,
  flagged in the freshness map).

Contract shared with utils/timeseries.py: ``SMP_FLEET_INTERVAL``
unset/0 constructs NOTHING — no thread, no bus traffic, no port.
"""

import collections
import json
import os
import statistics
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    SERVE_LATENCY_KINDS,
    merge_metric_reports,
    quantile_from_counts,
    render_prometheus_report,
    telemetry,
)
from smdistributed_modelparallel_tpu_torch.utils.timeseries import (
    SLO_ENV,
    evaluate_slo,
    parse_slo,
)

logger = get_logger()

FLEET_INTERVAL_ENV = "SMP_FLEET_INTERVAL"
FLEET_PATH_ENV = "SMP_FLEET_PATH"
METRICS_PORT_ENV = "SMP_METRICS_PORT"
STRAGGLER_RATIO_ENV = "SMP_FLEET_STRAGGLER_RATIO"
KV_IMBALANCE_RATIO_ENV = "SMP_FLEET_KV_IMBALANCE_RATIO"
STALE_WINDOWS_ENV = "SMP_FLEET_STALE_WINDOWS"

#: Reserved control tx for fleet metric snapshots (-1 exit relay, -2
#: preempt notice, -3 preempt step-edge, -4 heartbeats, -5 recovery
#: rendezvous, -6 serving mirror — see backend/native.py).
FLEET_TX = -7

#: Fleet windows kept in memory (the JSONL is the durable feed).
DEFAULT_RING = 256

_SNAPSHOT_VERSION = 1


def _flight():
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import (
        flight_recorder,
    )

    return flight_recorder


def _trigger_forensics(reason, detail):
    """Detector fire edges request an auto-forensics bundle; a no-op
    while SMP_FORENSICS_PATH is unset, and never raises — the metrics
    plane must not die collecting evidence."""
    try:
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        goodput.trigger_forensics(reason, detail=detail)
    except Exception:
        logger.warning("forensics trigger (%s) failed", reason,
                       exc_info=True)


def fleet_interval():
    """Publish/aggregate cadence in seconds; 0.0 disables the plane."""
    raw = os.environ.get(FLEET_INTERVAL_ENV, "")
    if not raw:
        return 0.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r; fleet plane stays off.",
                       FLEET_INTERVAL_ENV, raw)
        return 0.0


def metrics_port():
    """Scrape-endpoint port, or None when unset (no server). 0 binds an
    ephemeral port (tests / bench); the bound port is exposed as
    ``plane.bound_port``."""
    raw = os.environ.get(METRICS_PORT_ENV, "")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r; no scrape endpoint.",
                       METRICS_PORT_ENV, raw)
        return None


def _env_ratio(name, default):
    try:
        val = float(os.environ.get(name, "") or default)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r; using %s.",
                       name, os.environ.get(name), default)
        return float(default)
    return val if val > 0 else float(default)


def straggler_ratio():
    return _env_ratio(STRAGGLER_RATIO_ENV, 2.0)


def kv_imbalance_ratio():
    return _env_ratio(KV_IMBALANCE_RATIO_ENV, 2.0)


def stale_windows():
    return max(int(_env_ratio(STALE_WINDOWS_ENV, 3.0)), 1)


def _label_key(labels):
    return tuple(sorted((labels or {}).items()))


def _lower_median(values):
    """Deterministic 'typical rank' statistic for ratio detectors: the
    lower median never averages a straggler into the baseline (a plain
    median of a 2-rank fleet would be pulled halfway toward the slow
    rank and mask it)."""
    return sorted(values)[(len(values) - 1) // 2]


def _skew(per_rank):
    """min/max/median/sum skew stats over a ``{rank: value}`` map."""
    vals = list(per_rank.values())
    return {
        "min": min(vals),
        "max": max(vals),
        "median": statistics.median(vals),
        "sum": sum(vals),
        "by_rank": {str(r): per_rank[r] for r in sorted(per_rank)},
    }


class _ScrapeHandler(BaseHTTPRequestHandler):
    """GET-only scrape surface. Every route answers from in-memory
    state; nothing here blocks on the bus."""

    # Scrapes must not spam stdout (BaseHTTPRequestHandler logs every
    # request to stderr by default).
    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _reply(self, code, body, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code, doc):
        self._reply(code, json.dumps(doc).encode(), "application/json")

    def do_GET(self):  # noqa: N802 - stdlib signature
        plane = self.server.plane
        path = self.path.split("?", 1)[0]
        if path != "/" and path.endswith("/"):
            path = path.rstrip("/")
        try:
            if path == "/metrics":
                self._reply(200, plane.registry.render_prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json":
                self._json(200, plane.registry.report())
            elif path in ("/fleet", "/fleet/metrics"):
                if not plane.is_aggregator:
                    self._json(404, {
                        "error": "not the aggregator",
                        "rank": plane.rank,
                        "aggregator": plane.aggregator,
                    })
                    return
                doc = plane.fleet_report()
                if path == "/fleet":
                    self._json(200, doc)
                else:
                    body = render_prometheus_report(doc["merged"]).encode()
                    self._reply(200, body,
                                "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/":
                self._json(200, {
                    "rank": plane.rank,
                    "aggregator": plane.aggregator,
                    "paths": ["/metrics", "/metrics.json", "/fleet",
                              "/fleet/metrics"],
                })
            else:
                self._json(404, {"error": f"unknown path {path!r}"})
        except Exception as e:  # a broken scrape must not kill the server
            try:
                self._json(500, {"error": str(e)})
            except OSError:
                pass


class FleetMetricsPlane:
    """Publisher + (when elected) aggregator + scrape server for one
    rank. Constructed only when ``SMP_FLEET_INTERVAL`` is set —
    ``from_env`` returns None otherwise and NOTHING is built.

    ``clock``/``wall``/``alive_fn`` are injectable for the fake-clock
    detector unit tests; ``bus=None, world=1`` is the single-process
    degenerate case (this rank aggregates itself, no traffic).
    """

    def __init__(self, registry=None, bus=None, rank=None, world=None,
                 interval=None, path=None, slo=None, port=None,
                 straggler_ratio_=None, kv_imbalance_ratio_=None,
                 stale_windows_=None, alive_fn=None,
                 clock=time.monotonic, wall=time.time):
        self.registry = registry if registry is not None else telemetry
        self.bus = bus
        if bus is not None:
            default_rank, default_world = bus.rank, bus.world
        else:
            default_rank = self.registry.process_index or 0
            default_world = self.registry.process_count or 1
        self.rank = default_rank if rank is None else int(rank)
        self.world = default_world if world is None else int(world)
        self.interval = fleet_interval() if interval is None else float(
            interval)
        self.path = os.environ.get(FLEET_PATH_ENV, "") if path is None \
            else path
        self.port = metrics_port() if port is None else port
        self.straggler_ratio = straggler_ratio() \
            if straggler_ratio_ is None else float(straggler_ratio_)
        self.kv_imbalance_ratio = kv_imbalance_ratio() \
            if kv_imbalance_ratio_ is None else float(kv_imbalance_ratio_)
        self.stale_windows = stale_windows() \
            if stale_windows_ is None else int(stale_windows_)
        if slo is None:
            raw = os.environ.get(SLO_ENV, "")
            try:
                self.slo = parse_slo(raw) if raw else None
            except ValueError as e:
                logger.warning("ignoring invalid %s: %s", SLO_ENV, e)
                self.slo = None
        else:
            self.slo = parse_slo(slo) if isinstance(slo, str) else slo
        self._alive_fn = alive_fn
        self._clock = clock
        self._wall = wall

        self._lock = threading.RLock()
        self._thread = None
        self._stop_event = threading.Event()
        self._stopped = False
        self._server = None
        self._server_thread = None
        self.bound_port = None

        self._t_start = self._clock()
        self._last_tick = None
        self._pub_seq = 0
        self._seq = 0
        self._ok_windows = 0
        self._aggregator = None
        #: {rank: {"snap": snapshot, "t": clock_time_ingested}}
        self._snapshots = {}
        #: previous merged cumulative values, for window deltas.
        self._prev_counters = None
        self._prev_hists = None
        self._last_window_t = None
        self._ring = collections.deque(maxlen=DEFAULT_RING)
        #: detector state, for transition-edge events.
        self._straggling = set()
        self._stale = set()
        self._kv_imbalanced = False

    # -- construction ---------------------------------------------------

    @classmethod
    def from_env(cls, bus=None, registry=None):
        """The PR-16 timeseries contract: interval unset/0 -> None,
        nothing constructed — no thread, no bus traffic, no port."""
        if fleet_interval() <= 0:
            return None
        return cls(registry=registry, bus=bus)

    # -- liveness / election --------------------------------------------

    def _alive(self, peer):
        if peer == self.rank:
            return True
        if self._alive_fn is not None:
            return bool(self._alive_fn(peer))
        if self.bus is None:
            return False
        from smdistributed_modelparallel_tpu_torch.resilience.supervisor import (
            DEAD,
            classify_failed,
        )

        # Only DEAD excludes a rank from the plane: a wedged rank's
        # publisher thread may well still run, and its feed going quiet
        # is exactly what the stale-feed detector reports.
        return peer not in classify_failed(self.bus, (peer,), kinds=(DEAD,))

    def _dead_ranks(self):
        return sorted(r for r in range(self.world)
                      if r != self.rank and not self._alive(r))

    def _elect(self):
        """Lowest-alive rank. Every rank runs the same election against
        the same detector verdicts, so they converge without a round."""
        for r in range(self.world):
            if r == self.rank or self._alive(r):
                return r
        return self.rank

    @property
    def aggregator(self):
        with self._lock:
            if self._aggregator is None:
                return self._elect()
            return self._aggregator

    @property
    def is_aggregator(self):
        return self.aggregator == self.rank

    # -- publisher ------------------------------------------------------

    def _local_snapshot(self):
        report = self.registry.report()
        metrics = {}
        for name, fam in report["metrics"].items():
            # Strip help strings: they are identical on every rank and
            # would dominate the wire size of every snapshot.
            metrics[name] = {"kind": fam["kind"], "series": fam["series"]}
        return {
            "v": _SNAPSHOT_VERSION,
            "rank": self.rank,
            "seq": self._pub_seq,
            "t_wall": self._wall(),
            "phase": report["meta"].get("phase"),
            "metrics": metrics,
        }

    def _ingest(self, rank, snap, now):
        cur = self._snapshots.get(rank)
        if cur is not None and cur["snap"].get("seq", -1) > snap.get("seq",
                                                                    -1):
            return  # out-of-order frame from a slow drain
        self._snapshots[rank] = {"snap": snap, "t": now}

    # -- the per-interval tick ------------------------------------------

    def tick(self, now=None):
        """Cheap when idle: one clock read under the interval. Called
        from the daemon thread and inline from the serving engine's
        step loop (so a busy decode loop keeps the feed fresh even if
        the GIL starves the thread). Returns the fleet window dict when
        this tick aggregated one, else None."""
        with self._lock:
            if self._stopped:
                return None
            now = self._clock() if now is None else now
            if (self._last_tick is not None
                    and now - self._last_tick < self.interval):
                return None
            return self._tick_locked(now)

    def _tick_locked(self, now):
        self._last_tick = now
        self._pub_seq += 1
        snap = self._local_snapshot()
        agg = self._elect()
        if agg != self._aggregator:
            prev = self._aggregator
            self._aggregator = agg
            if prev is not None:
                logger.warning("fleet aggregator re-elected: rank %s -> %s",
                               prev, agg)
            _flight().record_fleet("elect", rank=agg,
                                   detail=f"prev={prev}")
            self.registry.gauge(
                "smp_fleet_aggregator",
                "rank currently aggregating the fleet metrics plane",
            ).set(agg)
            if agg == self.rank:
                # Takeover: our merged baseline (if any) predates the
                # gap, so the first window we cut is marked resync and
                # uses cumulative — not delta — percentiles.
                self._prev_counters = None
                self._prev_hists = None
        # Drain inbound frames regardless of role: under a stale
        # election peers may still address us, and the bus buffers are
        # bounded.
        if self.bus is not None:
            for p in range(self.world):
                if p == self.rank:
                    continue
                try:
                    frames = self.bus.drain_bytes(p, FLEET_TX)
                except Exception:
                    frames = []
                if self.rank != agg:
                    continue  # drained-and-dropped
                for raw in frames:
                    try:
                        peer_snap = json.loads(raw)
                    except (ValueError, UnicodeDecodeError):
                        continue
                    r = peer_snap.get("rank")
                    if isinstance(r, int) and 0 <= r < self.world:
                        self._ingest(r, peer_snap, now)
        if self.rank == agg:
            self._ingest(self.rank, snap, now)
            return self._aggregate_locked(now)
        if self.bus is not None:
            # rc deliberately ignored: -2 (link dead) means the
            # aggregator died; the election above flips next tick.
            self.bus.send_raw(agg, json.dumps(snap).encode(), FLEET_TX)
        return None

    # -- aggregator: merge + window + detectors -------------------------

    def _merge_ranks(self, now):
        """(ranks, merged_report, stale, dead) over alive snapshots."""
        dead = self._dead_ranks()
        entries = {r: e for r, e in self._snapshots.items()
                   if r == self.rank or self._alive(r)}
        stale = sorted(self._stale_ranks(now, entries))
        reports = {
            r: {"meta": {"rank": r}, "metrics": e["snap"]["metrics"]}
            for r, e in entries.items()
        }
        return sorted(entries), merge_metric_reports(reports), stale, dead

    def _stale_ranks(self, now, entries):
        """Alive ranks whose feed went quiet: never published, or the
        last snapshot is older than stale_windows intervals."""
        horizon = self.stale_windows * self.interval
        out = set()
        for r in range(self.world):
            if r == self.rank or not self._alive(r):
                continue
            e = entries.get(r)
            age = now - (e["t"] if e is not None else self._t_start)
            if age > horizon:
                out.add(r)
        return out

    def _per_rank_gauge(self, ranks, name, **labels):
        key = _label_key(labels)
        out = {}
        for r in ranks:
            e = self._snapshots.get(r)
            fam = e["snap"]["metrics"].get(name) if e else None
            if not fam:
                continue
            for s in fam["series"]:
                if _label_key(s.get("labels")) == key:
                    out[r] = s.get("value", 0.0)
                    break
        return out

    def _per_rank_hist(self, ranks, name, **labels):
        key = _label_key(labels)
        out = {}
        for r in ranks:
            e = self._snapshots.get(r)
            fam = e["snap"]["metrics"].get(name) if e else None
            if not fam:
                continue
            for s in fam["series"]:
                if (_label_key(s.get("labels")) == key
                        and s.get("count", 0) > 0):
                    out[r] = s
                    break
        return out

    @staticmethod
    def _hist_series(merged, name):
        fam = merged["metrics"].get(name)
        if not fam:
            return {}
        return {_label_key(s.get("labels")): s for s in fam["series"]}

    @staticmethod
    def _counter_values(merged, name):
        fam = merged["metrics"].get(name)
        if not fam:
            return {}
        return {_label_key(s.get("labels")): s.get("value", 0)
                for s in fam["series"]}

    def _aggregate_locked(self, now):
        ranks, merged, stale, dead = self._merge_ranks(now)
        self._seq += 1
        t_wall = self._wall()
        dt = now - (self._last_window_t if self._last_window_t is not None
                    else self._t_start)
        dt = max(dt, 1e-9)
        self._last_window_t = now

        counters = {
            name: self._counter_values(merged, name)
            for name in ("smp_serve_requests_total", "smp_serve_tokens_total")
        }
        hists = {}
        for kind in SERVE_LATENCY_KINDS:
            s = self._hist_series(
                merged, "smp_serve_latency_seconds").get(
                    _label_key({"kind": kind}))
            if s is not None:
                hists[kind] = s
        step = self._hist_series(merged, "smp_step_time_seconds").get(())
        if step is not None:
            hists["step_time"] = step

        resync = self._prev_counters is None
        window = {
            "kind": "fleet_window",
            "seq": self._seq,
            "t_wall": round(t_wall, 3),
            "window_s": round(dt, 3),
            "aggregator": self.rank,
            "ranks": ranks,
            "dead": dead,
            "stale": stale,
            "resync": resync,
        }

        # Counter deltas -> fleet rates.
        def delta(name, **labels):
            cur = counters.get(name, {}).get(_label_key(labels))
            if cur is None:
                return None
            if resync:
                return cur
            prev = self._prev_counters.get((name, _label_key(labels)), 0)
            return max(cur - prev, 0)

        for event in ("admitted", "finished", "readmitted",
                      "deadline_miss"):
            d = delta("smp_serve_requests_total", event=event)
            if d is not None:
                window[f"requests_{event}"] = d
        gen = delta("smp_serve_tokens_total", kind="generated")
        if gen is not None:
            window["tokens_generated"] = gen
        # Rates only on true delta windows: a resync window's "delta" is
        # the cumulative total over an ill-defined interval.
        if not resync:
            if gen is not None:
                window["tokens_per_s"] = round(gen / dt, 3)
            fin = window.get("requests_finished")
            if fin is not None:
                window["requests_per_s"] = round(fin / dt, 3)

        # Window latency percentiles from merged bucket-count deltas
        # (cumulative counts on resync windows).
        for kind, s in hists.items():
            counts, hsum, hcount = s["counts"], s["sum"], s["count"]
            if not resync:
                pkey = (kind, tuple(s["buckets"]))
                prev = self._prev_hists.get(pkey)
                if prev is not None:
                    counts = [a - b for a, b in zip(counts, prev["counts"])]
                    if min(counts) < 0:  # rank set shrank; fall back
                        counts, window["resync"] = s["counts"], True
                    else:
                        hsum = s["sum"] - prev["sum"]
                        hcount = s["count"] - prev["count"]
            if hcount <= 0:
                continue
            for stat, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
                val = quantile_from_counts(s["buckets"], counts, q)
                if val is not None:
                    window[f"{kind}_{stat}_ms"] = round(val * 1e3, 3)
            window[f"{kind}_mean_ms"] = round(hsum / hcount * 1e3, 3)
            window[f"{kind}_count"] = hcount

        # Per-rank gauges -> skew stats; SLO sees the worst rank.
        qd = self._per_rank_gauge(ranks, "smp_serve_queue_depth")
        if qd:
            window["queue_depth_by_rank"] = _skew(qd)
            window["queue_depth"] = max(qd.values())
        kv_used = self._per_rank_gauge(ranks, "smp_serve_kv_blocks",
                                       state="used")
        if kv_used:
            window["kv_used_by_rank"] = _skew(kv_used)

        # Fleet goodput: per-rank wall-clock attribution counters merged
        # exactly like the histograms — counter summing IS rank
        # weighting (a rank with more attributed seconds weighs more).
        good = self._counter_values(merged, "smp_goodput_seconds_total")
        bad = self._counter_values(merged, "smp_badput_seconds_total")
        if good or bad:
            good_s = sum(good.values())
            bad_s = sum(bad.values())
            total = good_s + bad_s
            if total > 0:
                window["train_goodput"] = round(good_s / total, 4)
                window["badput_by_state"] = {
                    dict(key).get("state", "?"): round(val, 3)
                    for key, val in sorted(bad.items())
                }
                self.registry.gauge(
                    "smp_fleet_train_goodput",
                    "fleet wall-clock goodput fraction (merged goodput "
                    "seconds / merged attributed seconds, rank-weighted)",
                ).set(window["train_goodput"])
            gp = self._per_rank_gauge(ranks, "smp_goodput_fraction")
            if gp:
                window["goodput_by_rank"] = _skew(gp)

        self._detect_stragglers(ranks, window)
        self._detect_kv_imbalance(kv_used, window)
        self._mark_stale(stale, dead, window)

        if self.slo:
            verdict = evaluate_slo(self.slo, window)
            if verdict["ok"]:
                self._ok_windows += 1
            verdict["goodput"] = self._ok_windows / self._seq
            window["slo"] = verdict
            self.registry.gauge(
                "smp_fleet_goodput_fraction",
                "fraction of fleet windows with zero fleet-level SLO "
                "violations",
            ).set(verdict["goodput"])

        # Remember cumulative values for the next window's deltas.
        self._prev_counters = {
            (name, key): val
            for name, vals in counters.items() for key, val in vals.items()
        }
        self._prev_hists = {
            (kind, tuple(s["buckets"])): {
                "counts": list(s["counts"]), "sum": s["sum"],
                "count": s["count"],
            }
            for kind, s in hists.items()
        }

        self.registry.gauge(
            "smp_fleet_windows", "fleet windows aggregated so far"
        ).set(self._seq)
        self.registry.gauge(
            "smp_fleet_ranks", "ranks contributing to the fleet merge"
        ).set(len(ranks))

        self._ring.append(window)
        self._append_jsonl(window)
        return window

    # -- detectors ------------------------------------------------------

    def _detect_stragglers(self, ranks, window):
        """Per-rank ITL p99 (falling back to step-time) against the
        fleet lower-median of per-rank p99s. Cumulative distributions:
        a straggler verdict is a slowly-latching signal by design (an
        autoscaler should not flap on one bad window)."""
        per_rank = self._per_rank_hist(ranks, "smp_serve_latency_seconds",
                                       kind="itl")
        source = "itl"
        if len(per_rank) < 2:
            per_rank = self._per_rank_hist(ranks, "smp_step_time_seconds")
            source = "step_time"
        g_flag = self.registry.gauge(
            "smp_fleet_straggler",
            "1 when this rank's p99 exceeds the straggler ratio x fleet "
            "median",
        )
        g_ratio = self.registry.gauge(
            "smp_fleet_straggler_ratio",
            "this rank's p99 / fleet median p99 (itl, else step time)",
        )
        if len(per_rank) < 2:
            for r in list(self._straggling):
                g_flag.labels(rank=str(r)).set(0)
            self._straggling.clear()
            return
        p99 = {
            r: quantile_from_counts(s["buckets"], s["counts"], 0.99)
            for r, s in per_rank.items()
        }
        p99 = {r: v for r, v in p99.items() if v is not None}
        if len(p99) < 2:
            return
        median = _lower_median(list(p99.values()))
        stragglers = set()
        ratios = {}
        for r, v in sorted(p99.items()):
            ratio = v / median if median > 0 else 1.0
            ratios[r] = round(ratio, 3)
            g_ratio.labels(rank=str(r)).set(ratios[r])
            is_straggler = ratio > self.straggler_ratio
            g_flag.labels(rank=str(r)).set(1 if is_straggler else 0)
            if is_straggler:
                stragglers.add(r)
        newly = sorted(stragglers - self._straggling)
        for r in newly:
            _flight().record_fleet(
                "straggler", rank=r,
                detail=f"{source} p99 ratio {ratios[r]} > "
                       f"{self.straggler_ratio}")
        if newly:
            # A straggler verdict's fire edge is evidence-worthy: one
            # rate-limited forensic bundle (no-op while disarmed).
            _trigger_forensics(
                "fleet_straggler",
                f"ranks {newly} {source} p99 over "
                f"{self.straggler_ratio}x fleet median",
            )
        for r in sorted(self._straggling - stragglers):
            _flight().record_fleet("straggler_clear", rank=r, detail=source)
        self._straggling = stragglers
        if stragglers:
            window["straggler"] = {
                "source": source,
                "ranks": sorted(stragglers),
                "ratios": {str(r): ratios[r] for r in sorted(stragglers)},
            }

    def _detect_kv_imbalance(self, kv_used, window):
        if len(kv_used) < 2:
            return
        mean = sum(kv_used.values()) / len(kv_used)
        ratio = (max(kv_used.values()) / mean) if mean > 0 else 1.0
        self.registry.gauge(
            "smp_fleet_kv_imbalance_ratio",
            "max/mean of per-rank used paged-KV blocks",
        ).set(round(ratio, 3))
        imbalanced = ratio > self.kv_imbalance_ratio
        if imbalanced:
            worst = max(kv_used, key=lambda r: kv_used[r])
            window["kv_imbalance"] = {"ratio": round(ratio, 3),
                                      "worst_rank": worst}
            if not self._kv_imbalanced:
                _flight().record_fleet(
                    "kv_imbalance", rank=worst,
                    detail=f"max/mean {ratio:.2f} > "
                           f"{self.kv_imbalance_ratio}")
                _trigger_forensics(
                    "fleet_kv_imbalance",
                    f"rank {worst} max/mean {ratio:.2f} > "
                    f"{self.kv_imbalance_ratio}",
                )
        elif self._kv_imbalanced:
            _flight().record_fleet("kv_imbalance_clear")
        self._kv_imbalanced = imbalanced

    def _mark_stale(self, stale, dead, window):
        g = self.registry.gauge(
            "smp_fleet_stale_feed",
            "1 when this rank heartbeats but stopped publishing metric "
            "snapshots",
        )
        stale = set(stale)
        for r in sorted(stale - self._stale):
            g.labels(rank=str(r)).set(1)
            _flight().record_fleet("stale_feed", rank=r)
        for r in sorted(self._stale - stale):
            g.labels(rank=str(r)).set(0)
            _flight().record_fleet("stale_feed_clear", rank=r)
        self._stale = stale
        if dead:
            window["dead"] = dead

    # -- merged views ---------------------------------------------------

    def fleet_report(self, now=None):
        """The scrape endpoint's merged JSON document: fleet percentiles
        computed from merged cumulative bucket counts — bit-equal to
        ``telemetry_report.py --dir`` over the same ranks' dumps — plus
        per-rank freshness and the merged metric families themselves."""
        with self._lock:
            now = self._clock() if now is None else now
            ranks, merged, stale, dead = self._merge_ranks(now)
            freshness = {}
            for r in ranks:
                e = self._snapshots[r]
                freshness[str(r)] = {
                    "age_s": round(max(now - e["t"], 0.0), 3),
                    "seq": e["snap"].get("seq"),
                    "phase": e["snap"].get("phase"),
                    "stale": r in stale,
                }
            percentiles = {}
            lat = self._hist_series(merged, "smp_serve_latency_seconds")
            for kind in SERVE_LATENCY_KINDS:
                s = lat.get(_label_key({"kind": kind}))
                if s is None or s.get("count", 0) <= 0:
                    continue
                percentiles[kind] = self._percentile_doc(s)
            step = self._hist_series(
                merged, "smp_step_time_seconds").get(())
            if step is not None and step.get("count", 0) > 0:
                percentiles["step_time"] = self._percentile_doc(step)
            return {
                "kind": "fleet_report",
                "t_wall": self._wall(),
                "aggregator": self.rank,
                "world": self.world,
                "ranks": ranks,
                "dead": dead,
                "stale": stale,
                "windows": self._seq,
                "freshness": freshness,
                "percentiles": percentiles,
                "merged": merged,
            }

    @staticmethod
    def _percentile_doc(series):
        doc = {"count": series["count"]}
        for stat, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            doc[f"{stat}_s"] = quantile_from_counts(
                series["buckets"], series["counts"], q)
        if series["count"] > 0:
            doc["mean_s"] = series["sum"] / series["count"]
        return doc

    def windows(self):
        with self._lock:
            return list(self._ring)

    def last_window(self):
        """Newest aggregated window, or None before the first closes.
        The serving controller's policy tick reads this: one fresh
        window per evaluation, no ring scan."""
        with self._lock:
            return self._ring[-1] if self._ring else None

    @property
    def straggling(self):
        with self._lock:
            return set(self._straggling)

    def _append_jsonl(self, window):
        if not self.path:
            return
        # Deliberately NOT rank-qualified (unlike every other dump):
        # only the live aggregator writes, and a successor appending to
        # the same file is what keeps the feed continuous across
        # failover.
        try:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(window) + "\n")
        except OSError as e:
            logger.warning("fleet window append to %s failed: %s",
                           self.path, e)

    # -- lifecycle ------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="smp-fleet", daemon=True)
        self._thread.start()
        if self.port is not None:
            self._start_server()
        return self

    def _loop(self):
        while not self._stop_event.wait(self.interval):
            try:
                self.tick()
            except Exception:  # the metrics plane must never kill a run
                logger.warning("fleet tick failed", exc_info=True)

    def _start_server(self):
        try:
            server = ThreadingHTTPServer(("", self.port), _ScrapeHandler)
        except OSError as e:
            logger.warning("could not bind %s=%s: %s; no scrape endpoint.",
                           METRICS_PORT_ENV, self.port, e)
            return
        server.daemon_threads = True
        server.plane = self
        self._server = server
        self.bound_port = server.server_address[1]
        self._server_thread = threading.Thread(
            target=server.serve_forever, name="smp-fleet-http", daemon=True)
        self._server_thread.start()
        logger.info("fleet scrape endpoint on port %s", self.bound_port)

    def stop(self):
        """Final-flush + teardown; idempotent. Runs BEFORE the exit
        relay closes the bus (core.shutdown ordering), so the last
        snapshot/window still travels."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            if not self._stopped:
                self._stopped = True
                try:
                    now = self._clock()
                    if self.is_aggregator:
                        self._ingest(self.rank, self._local_snapshot(), now)
                        self._aggregate_locked(now)
                    elif self.bus is not None:
                        self.bus.send_raw(
                            self._aggregator
                            if self._aggregator is not None
                            else self._elect(),
                            json.dumps(self._local_snapshot()).encode(),
                            FLEET_TX)
                except Exception:
                    logger.warning("fleet final flush failed", exc_info=True)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._server_thread = None
            self.bound_port = None


class FleetController:
    """Process-wide singleton (``smp.fleet``): owns the plane's
    lifecycle so core init/shutdown and the serving engine never have
    to know whether the plane is enabled."""

    def __init__(self):
        self.plane = None

    def start(self, bus=None):
        """(Re-)construct from env. Called by state.initialize after the
        supervisor is up; recovery re-init lands here again, so an
        existing plane is stopped first."""
        self.stop()
        if bus is None:
            bus = self._bus()
        self.plane = FleetMetricsPlane.from_env(bus=bus)
        if self.plane is not None:
            self.plane.start()
        return self.plane

    @staticmethod
    def _bus():
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        return state.bus

    def tick(self):
        if self.plane is not None:
            self.plane.tick()

    def last_window(self):
        return self.plane.last_window() if self.plane is not None else None

    def stop(self):
        if self.plane is not None:
            plane, self.plane = self.plane, None
            plane.stop()

    def reset(self):
        self.stop()


fleet = FleetController()
