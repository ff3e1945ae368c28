"""Pipeline timeline: Chrome-trace (Perfetto-loadable) event recording.

Counterpart of ``smdistributed_modelparallel_tpu/utils/timeline.py``
(reference C++ timeline, ``smp_create_timeline`` / ``smp_timeline_start_step``
/ ``smp_timeline_end_step`` / ``smp_timeline_record_pipeline_event``). Events
bracket host-side phases (the step's microbatches, the optimizer, serving
ticks) and per-step execution, and the JSON file loads in chrome://tracing or
Perfetto beside a ``torch.profiler`` trace.

Recording backend, as in the JAX package: the native C++ recorder
(``native/src/timeline.cc`` through ``backend/native.NativeTimeline``:
interned strings, a preallocated arena, C-side JSON) when the port's build of
the native library loads; a list append otherwise. Same API and the same
output either way.

Multi-rank discipline:

- the output path is **rank-qualified** (telemetry's ``_rank_path``): N
  processes pointed at one ``SMP_TIMELINE_PATH`` on a shared filesystem
  write ``path.rank<i>`` files instead of clobbering each other;
- ``flush()`` is **atomic** (tmp file + ``os.replace``) so a concurrent
  reader — or ``scripts/trace_fuse.py`` running mid-job — never sees a
  torn JSON;
- every timeline opens with a ``smp_clock_anchor/<unix_us>/<rank>``
  instant (the wall-clock time of the timeline's t=0) and records
  ``smp_sync/<name>/<group>/<seq>`` instants at barrier exits;
  ``trace_fuse.py`` parses them to align per-rank clocks into one fused
  trace.
"""

import os
import threading
import time

from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    _atomic_json_dump,
    telemetry,
)


class Timeline:
    def __init__(self, path=None):
        raw = path or os.environ.get("SMP_TIMELINE_PATH", "")
        self.enabled = bool(raw)
        # Rank-qualify ONCE, at construction (state.initialize builds the
        # timeline after core init, so the process index is known).
        self.path = telemetry._rank_path(raw) if raw else raw
        self._events = []
        self._lock = threading.Lock()
        self._step = -1
        # Anchor: wall-clock of the timeline's t=0, captured back-to-back
        # with the monotonic origin.
        self._wall0_us = int(time.time() * 1e6)
        self._t0 = time.perf_counter()
        self._native = None
        if self.enabled:
            from smdistributed_modelparallel_tpu_torch.backend import native

            lib = native.load()
            if lib is not None:
                # The native recorder writes to the path it was created
                # with: the tmp name, which flush() installs atomically.
                self._native = native.NativeTimeline(lib, self._tmp_path())
            rank = telemetry.process_index
            name = (f"smp_clock_anchor/{self._wall0_us}/"
                    f"{0 if rank is None else rank}")
            # The anchor instant carries ts=0 EXACTLY: _wall0_us is the
            # wall time of the monotonic origin (the library load above may
            # have taken a while).
            if self._native is not None:
                self._native.record_instant(name, 0.0, "sync")
            else:
                self._events.append(
                    {"name": name, "ph": "i", "ts": 0.0, "pid": 0,
                     "tid": "sync", "s": "g"}
                )

    def _tmp_path(self):
        return f"{self.path}.tmp.{os.getpid()}"

    def _now_us(self):
        return (time.perf_counter() - self._t0) * 1e6

    def start_step(self, step):
        self._step = step
        if self._native is not None:
            self._native.start_step(step)
        self.record_instant(f"step_{step}_begin")

    def end_step(self, step):
        self.record_instant(f"step_{step}_end")
        if self._native is not None:
            self._native.end_step(step)

    def sync_mark(self, name, group, seq):
        """Barrier-exit alignment instant (see module docstring)."""
        self.record_instant(f"smp_sync/{name}/{group}/{seq}", track="sync")

    def record_event(self, name, begin_us, end_us, microbatch=None, track="pipeline"):
        if not self.enabled:
            return
        if self._native is not None:
            self._native.record_event(name, begin_us, end_us, microbatch, track)
            return
        args = {"step": self._step}
        if microbatch is not None:
            args["microbatch"] = microbatch
        with self._lock:
            self._events.append(
                {"name": name, "ph": "X", "ts": begin_us, "dur": end_us - begin_us,
                 "pid": 0, "tid": track, "args": args}
            )

    def record_instant(self, name, track="pipeline"):
        if not self.enabled:
            return
        if self._native is not None:
            self._native.record_instant(name, self._now_us(), track)
            return
        with self._lock:
            self._events.append(
                {"name": name, "ph": "i", "ts": self._now_us(), "pid": 0,
                 "tid": track, "s": "g"}
            )

    class _Span:
        def __init__(self, timeline, name, microbatch, track):
            self.timeline, self.name, self.microbatch, self.track = timeline, name, microbatch, track

        def __enter__(self):
            self.begin = self.timeline._now_us()
            return self

        def __exit__(self, *exc):
            self.timeline.record_event(
                self.name, self.begin, self.timeline._now_us(),
                microbatch=self.microbatch, track=self.track,
            )
            return False

    def span(self, name, microbatch=None, track="host"):
        return self._Span(self, name, microbatch, track)

    def flush(self):
        if not self.enabled:
            return
        if self._native is not None:
            # C-side serialization lands in the tmp name; atomic install.
            self._native.flush(pid=os.getpid())
            try:
                os.replace(self._tmp_path(), self.path)
            except OSError as e:
                from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

                get_logger().warning("timeline flush to %s failed: %s", self.path, e)
            return
        if not self._events:
            return
        with self._lock:
            payload = {"traceEvents": list(self._events),
                       "displayTimeUnit": "ms"}
        # telemetry's tmp+os.replace helper: atomic, and WARNS on failure
        # (a silently missing trace is only discovered post-run).
        _atomic_json_dump(payload, self.path, "timeline flush")
