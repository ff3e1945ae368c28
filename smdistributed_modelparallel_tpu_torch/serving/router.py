"""Request router and replica handles of the serving control plane.

Counterpart of ``smdistributed_modelparallel_tpu/serving/router.py``, with
its names, frames, tx and decisions. The router is the deployment's front
door: every ``ServeRequest`` enters here and goes to the least-loaded LIVE
replica (ties to the lower name), optionally split across weight VERSIONS
(the blue/green canary shifts a fraction of traffic to the new version; the
split is by a hash of the request id, ``_rid_fraction``, so the same request
always lands on the same version).

Two handle flavors present the same surface to the router:

- ``LocalReplicaHandle`` wraps an in-process ``ServingEngine``;
- ``RemoteReplicaHandle`` speaks JSON frames over the native bus's reserved
  control tx ``ROUTER_TX`` (-8) to a ``ReplicaServer`` loop on a peer
  process, on the quiet ``send_raw``/``drain_bytes`` path heartbeats and
  mirror frames use (router traffic consumes no chaos bus-send ordinal). A
  standby peer parks in ``ReplicaServer.serve()`` until the controller's
  scale-up activates it; activation builds the engine through the caller's
  factory.

The port's warm start. The JAX package's ready frame carries its executable
cache's compile-event counts by source. The port has no executable cache
(ROADMAP item 10): its compile is the first load of a kernel library in the
process (``ops/_build.load``), ``"fresh"`` when ``nvcc`` built it and
``"disk_cache"`` when the library was already on disk
(``utils/exec_cache.compile_events_since``). So the ready frame's ``warm``
counts those by source, and a warm scale-up (the libraries built once, by an
earlier process) shows ``fresh == 0``. A factory that loads no kernel reports
``{}``.

Reserved control tx map: -1 exit relay, -2 preempt notice, -3 preempt
step-edge, -4 heartbeats, -5 recovery rendezvous, -6 serve mirror, -7 fleet
snapshots, -8 THIS (``backend/native.py``).

Wire frames (all JSON, controller -> replica):
  ``{"op": "activate", "version": V}``   build engine, reply ready
  ``{"op": "submit", "req": record}``    mirror-record wire format
  ``{"op": "drain"}``                    drain protocol, reply drained
  ``{"op": "deactivate"}``               leave the serve loop

replica -> controller:
  ``{"op": "ready", "seconds": s, "warm": {...}}``
  ``{"op": "finished", "rid": r, "tokens": [...]}``
  ``{"op": "load", "queue": q, "active": a}``
  ``{"op": "drained", "stragglers": [...], "results": {...}}``
"""

import hashlib
import json
import time

from smdistributed_modelparallel_tpu_torch.serving.engine import (
    serve_request_to_record,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPValidationError,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_route

logger = get_logger()

#: Reserved control tx for router/controller frames (see module doc).
ROUTER_TX = -8


def _rid_fraction(rid):
    """Deterministic [0, 1) position for a request id: the first 8 hex
    digits of its sha1. Version splits cut this line into segments, so
    the SAME rid always maps to the same version regardless of replica
    count or arrival order."""
    h = hashlib.sha1(str(rid).encode()).hexdigest()[:8]
    return int(h, 16) / float(0x100000000)


class LocalReplicaHandle:
    """Router-facing wrapper around an in-process ``ServingEngine``."""

    def __init__(self, name, engine, version=0):
        self.name = str(name)
        self.engine = engine
        self.version = int(version)
        self.live = True

    def load(self):
        """Queued + in-flight request count (the least-loaded metric)."""
        return len(self.engine._queue) + self.engine.in_flight

    def submit(self, req):
        return self.engine.submit(req)

    def step(self):
        return self.engine.step()

    def poll(self):
        """No transport to pump for a local engine."""

    def drain(self, timeout_s=120.0):
        return self.engine.drain(timeout_s=timeout_s)

    def results(self):
        return dict(self.engine.results)

    @property
    def busy(self):
        return self.engine.busy


class RequestRouter:
    """Least-loaded dispatch across live replica handles with
    deterministic per-version traffic splits."""

    def __init__(self):
        self.handles = {}
        self._split = None       # list of (version, cumulative fraction)
        self.routed = {}         # handle name -> dispatched count

    # -- membership -----------------------------------------------------

    def attach(self, handle):
        if handle.name in self.handles:
            raise SMPValidationError(
                f"router: a handle named {handle.name!r} is already "
                "attached"
            )
        self.handles[handle.name] = handle
        self.routed.setdefault(handle.name, 0)
        return handle

    def detach(self, name):
        return self.handles.pop(str(name), None)

    def live_handles(self, version=None):
        out = [h for h in self.handles.values() if h.live]
        if version is not None:
            out = [h for h in out if h.version == int(version)]
        return out

    # -- version splits -------------------------------------------------

    def set_split(self, split):
        """``{version: fraction}`` with fractions summing to ~1, or None
        to route by load alone (all versions eligible)."""
        if split is None:
            self._split = None
            return
        total = float(sum(split.values()))
        if not split or abs(total - 1.0) > 1e-6:
            raise SMPValidationError(
                f"router: split fractions must sum to 1.0, got {split!r}"
            )
        acc, table = 0.0, []
        for version in sorted(split):
            acc += float(split[version])
            table.append((int(version), acc))
        self._split = table

    @property
    def split(self):
        return dict((v, f) for v, f in self._split or ())

    def _pick_version(self, rid):
        if self._split is None:
            return None
        x = _rid_fraction(rid)
        for version, cum in self._split:
            if x < cum:
                return version
        return self._split[-1][0]

    # -- dispatch -------------------------------------------------------

    def dispatch(self, req):
        """Route one request: version by rid hash (when a split is
        active), then the least-loaded live replica of that version
        (falling back to ANY live replica if none serves it — a split
        must degrade to availability, not to a drop). Returns the
        handle name, or None when no live replica exists."""
        version = self._pick_version(req.request_id)
        candidates = self.live_handles(version)
        if not candidates:
            candidates = self.live_handles()
        if not candidates:
            return None
        handle = min(candidates, key=lambda h: (h.load(), h.name))
        if not handle.submit(req):
            return None
        self.routed[handle.name] = self.routed.get(handle.name, 0) + 1
        record_route(handle.version)
        return handle.name

    def step_all(self):
        """One tick of every live handle; True while any has work."""
        busy = False
        for h in self.live_handles():
            busy = bool(h.step()) or busy
            h.poll()
        return busy

    def results(self):
        merged = {}
        for h in self.handles.values():
            merged.update(h.results())
        return merged


class RemoteReplicaHandle:
    """Controller-side proxy for a ``ReplicaServer`` on a peer
    process. Load/finished/drained state is whatever the last drained
    frames reported — ``poll()`` (called from ``step_all``) pumps the
    transport."""

    def __init__(self, name, bus, peer, version=0):
        self.name = str(name)
        self.bus = bus
        self.peer = int(peer)
        self.version = int(version)
        self.live = False
        self._load = 0
        self._results = {}
        self._stragglers = None
        self.warm = {}
        self.activate_seconds = None

    def _send(self, frame):
        self.bus.send_raw(self.peer, json.dumps(frame).encode(), ROUTER_TX)

    def _frames(self):
        out = []
        for raw in self.bus.drain_bytes(self.peer, ROUTER_TX):
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
        return out

    def activate(self, version=None, timeout_s=120.0):
        """Ask the standby peer to build its engine; blocks until the
        ready frame lands. Returns the warm-start report (exec-cache
        compile sources) so the caller can assert fresh == 0."""
        if version is not None:
            self.version = int(version)
        self._send({"op": "activate", "version": self.version})
        deadline = time.monotonic() + timeout_s
        while True:
            for frame in self._frames():
                if frame.get("op") == "ready":
                    self.live = True
                    self.warm = frame.get("warm", {})
                    self.activate_seconds = float(frame.get("seconds", 0.0))
                    return self.warm
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router: replica {self.name} did not activate "
                    f"within {timeout_s:.0f}s"
                )
            time.sleep(0.002)

    def load(self):
        return self._load

    def submit(self, req):
        self._send({"op": "submit", "req": serve_request_to_record(req)})
        self._load += 1   # optimistic until the next load frame lands
        return True

    def step(self):
        self.poll()
        return self._load > 0

    def poll(self):
        for frame in self._frames():
            op = frame.get("op")
            if op == "finished":
                self._results[frame["rid"]] = list(frame["tokens"])
            elif op == "load":
                self._load = int(frame.get("queue", 0)) + int(
                    frame.get("active", 0)
                )
            elif op == "drained":
                self._stragglers = list(frame.get("stragglers", ()))
                for rid, toks in frame.get("results", {}).items():
                    self._results[rid] = list(toks)
                self._load = 0

    def drain(self, timeout_s=120.0):
        """Run the drain protocol on the remote replica: it stops
        admitting, finishes in-flight streams, and ships back the
        queued-never-admitted stragglers as restartable records."""
        self._send({"op": "drain"})
        self._stragglers = None
        deadline = time.monotonic() + timeout_s
        while self._stragglers is None:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router: replica {self.name} did not drain within "
                    f"{timeout_s:.0f}s"
                )
            self.poll()
            time.sleep(0.002)
        self.live = False
        return list(self._stragglers)

    def deactivate(self):
        self._send({"op": "deactivate"})
        self.live = False

    def results(self):
        self.poll()
        return dict(self._results)

    @property
    def busy(self):
        return self._load > 0


class ReplicaServer:
    """Standby/serve loop for a replica process driven by a remote
    controller over ``ROUTER_TX``. ``factory()`` builds the local
    ``ServingEngine`` on activation — with ``SMP_EXEC_CACHE=on`` and a
    shared cache dir that construction is the warm start the scale-up
    MTTR measures."""

    def __init__(self, factory, bus, controller_rank=0):
        self.factory = factory
        self.bus = bus
        self.controller = int(controller_rank)
        self.engine = None

    def _send(self, frame):
        self.bus.send_raw(
            self.controller, json.dumps(frame).encode(), ROUTER_TX
        )

    def serve(self, timeout_s=300.0):
        """Park until activated, serve until deactivated (or drained and
        then deactivated). Returns the engine's results dict."""
        from smdistributed_modelparallel_tpu_torch.serving.engine import (
            serve_request_from_record,
        )
        from smdistributed_modelparallel_tpu_torch.utils import exec_cache

        deadline = time.monotonic() + timeout_s
        reported = set()
        last_load = None
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("ReplicaServer.serve timed out")
            frames = [
                json.loads(raw)
                for raw in self.bus.drain_bytes(self.controller, ROUTER_TX)
            ]
            for frame in frames:
                op = frame.get("op")
                if op == "activate" and self.engine is None:
                    t0 = time.perf_counter()
                    mark = exec_cache.compile_event_mark()
                    self.engine = self.factory()
                    warm = {}
                    for ev in exec_cache.compile_events_since(mark):
                        src = ev.get("source", "?")
                        warm[src] = warm.get(src, 0) + 1
                    self._send({
                        "op": "ready",
                        "seconds": time.perf_counter() - t0,
                        "warm": warm,
                    })
                    logger.info(
                        "[router] replica activated in %.2fs (%s)",
                        time.perf_counter() - t0, warm or "no compiles",
                    )
                elif op == "submit" and self.engine is not None:
                    self.engine.submit(
                        serve_request_from_record(frame["req"])
                    )
                elif op == "drain" and self.engine is not None:
                    stragglers = self.engine.drain()
                    self._send({
                        "op": "drained",
                        "stragglers": stragglers,
                        "results": {
                            rid: list(toks)
                            for rid, toks in self.engine.results.items()
                            if rid not in reported
                        },
                    })
                    reported.update(self.engine.results)
                    self.engine.resume_admission()
                elif op == "deactivate":
                    results = {}
                    if self.engine is not None:
                        results = dict(self.engine.results)
                        self.engine.close()
                        self.engine = None
                    return results
            if self.engine is None:
                time.sleep(0.002)
                continue
            self.engine.step()
            for rid in list(self.engine.finished):
                if rid in reported:
                    continue
                reported.add(rid)
                self._send({
                    "op": "finished",
                    "rid": rid,
                    "tokens": list(self.engine.results.get(rid, ())),
                })
            loadnow = (
                len(self.engine._queue) + self.engine.in_flight
            )
            if loadnow != last_load:
                last_load = loadnow
                self._send({
                    "op": "load",
                    "queue": len(self.engine._queue),
                    "active": self.engine.in_flight,
                })
            if not self.engine.last_tick_worked:
                time.sleep(0.001)
