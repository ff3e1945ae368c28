"""Loader and ctypes wrappers of the native host runtime of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/backend/native.py``: the
same library from the same sources, ``native/src/message_bus.cc`` and
``native/src/timeline.cc``, bound the same way:

- **message bus** (``smp_bus_listen`` / ``smp_bus_connect`` /
  ``smp_async_send`` / ``smp_wait_recv`` / ``smp_poll_recv`` /
  ``smp_retrieve_object`` / ``smp_clean_recv_resources`` /
  ``smp_bus_barrier`` / ``smp_peer_down`` / ``smp_bus_shutdown``): a TCP
  mesh between host processes for control-plane objects, keyed by
  (source, transaction id), with real subgroup barriers (``MessageBus``);
- **timeline recorder** (``smp_create_timeline`` and its family;
  ``NativeTimeline``).

Build. The JAX package rebuilds ``native/libsmptpu.so`` in place, and that
file is tracked; the port never writes under ``native/``. At first use it
compiles the sources with ``g++ -O2 -std=c++17 -fPIC -pthread -shared`` into
``_build/libsmptpu.so`` (beside the CUDA libraries of ``ops/_build.py``,
ignored by git), under an inter-process file lock (``_build/.native.lock``:
the ranks of one host reach ``smp.init`` together) into a temporary name
installed by an atomic rename, and rebuilds when a source is newer than the
library. ``SMP_DISABLE_NATIVE=1`` turns the library off (``load()`` is None),
as in the JAX package; a build or load failure is logged and ``load()`` is
None too. Whoever needs the bus decides what a missing library means: the
communicator (``backend/collectives.py``) raises where the bus is required.

Conduct, as in the JAX package: every bus send goes through chaos's
``on_bus_send`` seam (``bus_drop``/``bus_error``), retries a dead link
``SMP_BUS_SEND_RETRIES`` times with exponential backoff and then raises
``SMPPeerLost``; a receive or barrier on a peer whose link is marked dead
raises ``SMPPeerLost`` at once; an unbounded wait under an armed watchdog
dumps its diagnostics and raises ``SMPWatchdogTimeout``; the flight
recorder gets both edges of every wait.

Import-hygiene contract: stdlib + package modules only.
"""

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPPeerLost, SMPWatchdogTimeout
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import watchdog

logger = get_logger()

_PKG = Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG.parent / "native" / "src"
SOURCES = ("message_bus.cc", "timeline.cc")
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsmptpu.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _stale():
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((NATIVE_SRC / s).stat().st_mtime > built for s in SOURCES)


def _build():
    """Compile the sources into ``LIB_PATH`` under the build lock; True on
    success."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libsmptpu.build.{os.getpid()}.so"
    try:
        with open(BUILD_DIR / ".native.lock", "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            if not _stale():  # a peer built it while we waited
                return True
            subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_SRC / s) for s in SOURCES)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native host runtime build failed (%s) %s", e, detail.decode(errors="replace")[-2000:])
        try:
            tmp.unlink()
        except OSError:
            pass
        return False


def _declare(lib):
    c = ctypes
    lib.smp_bus_listen.argtypes = [c.c_int]
    lib.smp_bus_listen.restype = c.c_int
    lib.smp_bus_connect.argtypes = [c.c_int, c.c_int, c.c_char_p]
    lib.smp_bus_connect.restype = c.c_int
    lib.smp_async_send.argtypes = [c.c_int, c.c_char_p, c.c_int64, c.c_int64]
    lib.smp_async_send.restype = c.c_int
    lib.smp_poll_recv.argtypes = [c.c_int, c.c_int64]
    lib.smp_poll_recv.restype = c.c_int
    lib.smp_wait_recv.argtypes = [c.c_int, c.c_int64, c.c_int]
    lib.smp_wait_recv.restype = c.c_int64
    lib.smp_retrieve_object.argtypes = [c.c_int, c.c_int64, c.POINTER(c.c_uint8), c.c_int64]
    lib.smp_retrieve_object.restype = c.c_int64
    lib.smp_clean_recv_resources.argtypes = [c.c_int, c.c_int64]
    lib.smp_clean_recv_resources.restype = None
    lib.smp_bus_barrier.argtypes = [c.POINTER(c.c_int), c.c_int, c.c_int]
    lib.smp_bus_barrier.restype = c.c_int
    lib.smp_peer_down.argtypes = [c.c_int]
    lib.smp_peer_down.restype = c.c_int
    lib.smp_bus_shutdown.argtypes = []
    lib.smp_bus_shutdown.restype = None

    lib.smp_create_timeline.argtypes = [c.c_char_p]
    lib.smp_create_timeline.restype = c.c_void_p
    lib.smp_destroy_timeline.argtypes = [c.c_void_p]
    lib.smp_destroy_timeline.restype = None
    lib.smp_timeline_start_step.argtypes = [c.c_void_p, c.c_int64]
    lib.smp_timeline_start_step.restype = None
    lib.smp_timeline_end_step.argtypes = [c.c_void_p, c.c_int64]
    lib.smp_timeline_end_step.restype = c.c_int64
    lib.smp_timeline_record_pipeline_event.argtypes = [
        c.c_void_p, c.c_char_p, c.c_double, c.c_double, c.c_int, c.c_char_p,
    ]
    lib.smp_timeline_record_pipeline_event.restype = None
    lib.smp_timeline_record_instant.argtypes = [c.c_void_p, c.c_char_p, c.c_double, c.c_char_p]
    lib.smp_timeline_record_instant.restype = None
    lib.smp_timeline_flush.argtypes = [c.c_void_p, c.c_int]
    lib.smp_timeline_flush.restype = c.c_int
    lib.smp_timeline_event_count.argtypes = [c.c_void_p]
    lib.smp_timeline_event_count.restype = c.c_int64
    return lib


def load():
    """The loaded library, built first where needed; None when it is turned
    off (``SMP_DISABLE_NATIVE=1``) or failed to build or load."""
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("SMP_DISABLE_NATIVE", "0") == "1":
            return None
        if _stale() and not _build():
            return None
        try:
            _lib = _declare(ctypes.CDLL(str(LIB_PATH)))
        except OSError as e:
            logger.warning("could not load %s: %s", LIB_PATH, e)
            _lib = None
        return _lib


def available():
    return load() is not None


class MessageBus:
    """Python face of the native bus; one per process.

    Transaction ids follow the reference's ``TransactionIdentifier``
    convention (2*id + is_user_api); the bus itself sees opaque int64 keys.
    Negative ids are the framework's control channels: -1 the exit-status
    relay, -2 the preemption notice, -3 the preemption step exchange, -4
    heartbeats, -5 eviction notices, -7 the fleet plane.
    """

    def __init__(self, lib):
        self._lib = lib
        self.rank = 0
        self.world = 1
        self.port = None
        self._connected = False

    def listen(self, port=0):
        self.port = self._lib.smp_bus_listen(port)
        if self.port < 0:
            raise OSError("smp_bus_listen failed")
        return self.port

    def connect(self, rank, world, endpoints):
        """``endpoints``: "host:port" strings indexed by process."""
        if self._lib.smp_bus_connect(rank, world, ",".join(endpoints).encode()) != 0:
            raise OSError("smp_bus_connect failed")
        self.rank, self.world = rank, world
        self._connected = True

    def send_bytes(self, dest, payload, tx):
        """Enqueue one message. A dead link (``-2`` from the C side: the
        sender thread gave up) is retried ``SMP_BUS_SEND_RETRIES`` times
        (default 3) with exponential backoff, then raises ``SMPPeerLost``;
        a misuse (``-1``: not connected, bad destination) raises OSError."""
        injected = chaos.on_bus_send(dest)
        if injected == "drop":
            flight_recorder.record_wait("bus_send", dest, tx, "chaos_drop", 0.0)
            return
        try:
            retries = max(int(os.environ.get("SMP_BUS_SEND_RETRIES", "3")), 0)
        except ValueError:
            logger.warning("ignoring non-integer SMP_BUS_SEND_RETRIES=%r; using 3.",
                           os.environ.get("SMP_BUS_SEND_RETRIES"))
            retries = 3
        delay = 0.05
        for attempt in range(retries + 1):
            rc = -2 if injected == "error" and attempt == 0 else \
                self._lib.smp_async_send(dest, payload, len(payload), tx)
            if rc == 0:
                if attempt:
                    logger.warning("bus send to process %d succeeded after %d retr%s.",
                                   dest, attempt, "y" if attempt == 1 else "ies")
                return
            if rc == -1:
                raise OSError(f"smp_async_send to {dest} failed ({rc})")
            if attempt < retries:
                flight_recorder.record_wait("bus_send", dest, tx, "retry", delay)
                time.sleep(delay)
                delay *= 2
        flight_recorder.record_wait("bus_send", dest, tx, "peer_lost", 0.0)
        raise SMPPeerLost(
            dest,
            f"native-bus link to process {dest} is dead (sender gave up delivering; rc={rc}) after "
            f"{retries} retr{'y' if retries == 1 else 'ies'}.",
        )

    def poll(self, src, tx):
        return bool(self._lib.smp_poll_recv(src, tx))

    def peer_down(self, peer):
        """True when the link to ``peer`` is marked dead in either direction
        (its sender thread gave up, or its connection hit EOF while the bus
        ran: the peer's process died)."""
        return bool(self._lib.smp_peer_down(peer))

    def _wait_recv(self, src, tx, timeout_ms):
        """The blocking C wait in slices of at most a second: a peer whose
        link is marked dead raises ``SMPPeerLost`` (frames delivered before
        the death drain first), and an unbounded wait under an armed
        watchdog dumps and raises ``SMPWatchdogTimeout``. A caller's own
        timeout keeps its ``TimeoutError`` (returned here as -1)."""
        if timeout_ms == 0:
            return self._lib.smp_wait_recv(src, tx, 0)
        now = time.monotonic()
        deadline = None if timeout_ms < 0 else now + timeout_ms / 1000.0
        wd = watchdog.timeout() if timeout_ms < 0 else None
        wd_deadline = None if wd is None else now + wd
        while True:
            if src != self.rank and not self._lib.smp_poll_recv(src, tx) and self.peer_down(src):
                raise SMPPeerLost(
                    src, f"bus recv from process {src} (tx={tx}): the link is marked dead (peer process "
                         "unreachable or exited).",
                )
            now = time.monotonic()
            slice_ms = 1000
            if deadline is not None:
                left_ms = int((deadline - now) * 1000)
                if left_ms <= 0:
                    return -1
                slice_ms = min(slice_ms, max(left_ms, 1))
            if wd_deadline is not None:
                wd_left = int((wd_deadline - now) * 1000)
                if wd_left <= 0:
                    watchdog.dump(f"bus recv from process {src} (tx={tx}) stalled >{wd}s")
                    raise SMPWatchdogTimeout(
                        f"watchdog: bus recv from process {src} stalled for more than {wd}s (diagnostics dumped)."
                    )
                slice_ms = min(slice_ms, max(wd_left, 1))
            n = self._lib.smp_wait_recv(src, tx, slice_ms)
            if n != -1:  # -1: the slice timed out
                return n

    def recv_bytes(self, src, tx, timeout_ms=-1):
        """The next frame from ``src`` on ``tx``; ``timeout_ms`` < 0 waits
        without a limit of its own."""
        flight_recorder.record_wait("bus_recv", src, tx, "begin", 0.0)
        t0 = time.monotonic()
        try:
            n = self._wait_recv(src, tx, timeout_ms)
        except SMPWatchdogTimeout:
            flight_recorder.record_wait("bus_recv", src, tx, "watchdog", time.monotonic() - t0)
            raise
        except SMPPeerLost:
            flight_recorder.record_wait("bus_recv", src, tx, "peer_lost", time.monotonic() - t0)
            raise
        elapsed = time.monotonic() - t0
        if n == -1:
            flight_recorder.record_wait("bus_recv", src, tx, "timeout", elapsed)
            raise TimeoutError(f"recv from {src} (tx={tx}) timed out")
        if n < 0:
            flight_recorder.record_wait("bus_recv", src, tx, "error", elapsed)
            raise OSError(f"smp_wait_recv failed ({n})")
        flight_recorder.record_wait("bus_recv", src, tx, "ok", elapsed)
        return self._retrieve(src, tx, n)

    def _retrieve(self, src, tx, n):
        buf = (ctypes.c_uint8 * int(n))()
        got = self._lib.smp_retrieve_object(src, tx, buf, n)
        if got != n:
            raise OSError(f"smp_retrieve_object failed ({got})")
        return bytes(buf)

    def clean(self, src, tx):
        self._lib.smp_clean_recv_resources(src, tx)

    def send_raw(self, dest, payload, tx):
        """One enqueue without the chaos seam, retries or flight recording;
        returns the C code (0 ok, -1 misuse, -2 link dead). Heartbeats (tx
        -4) and fleet snapshots (tx -7) use it: a periodic beat must not
        consume chaos's send ordinals, and a dead link is the signal."""
        return self._lib.smp_async_send(dest, payload, len(payload), tx)

    def drain_bytes(self, src, tx, limit=256):
        """Every frame already delivered for (src, tx), without blocking or
        flight recording."""
        out = []
        while len(out) < limit and self._lib.smp_poll_recv(src, tx):
            n = self._lib.smp_wait_recv(src, tx, 0)
            if n < 0:
                break
            try:
                out.append(self._retrieve(src, tx, n))
            except OSError:
                break
        return out

    def barrier(self, ranks, timeout_ms=600000):
        """Barrier over the processes ``ranks``. A member whose link is
        marked dead raises ``SMPPeerLost``; a wait that used up an armed
        watchdog's window dumps and raises ``SMPWatchdogTimeout``; other
        failures raise OSError."""
        wd = watchdog.timeout()
        if wd is not None:
            timeout_ms = min(timeout_ms, max(int(wd * 1000), 1))
        arr = (ctypes.c_int * len(ranks))(*sorted(ranks))
        flight_recorder.record_wait("bus_barrier", -1, len(ranks), "begin", 0.0)
        t0 = time.monotonic()
        rc = self._lib.smp_bus_barrier(arr, len(ranks), timeout_ms)
        if rc <= -100:
            peer = -(rc + 100)
            flight_recorder.record_wait("bus_barrier", peer, len(ranks), "peer_lost", time.monotonic() - t0)
            raise SMPPeerLost(
                peer, f"bus barrier over {sorted(ranks)}: the link to process {peer} is marked dead (peer "
                      "unreachable or exited).",
            )
        if rc != 0:
            elapsed_ms = (time.monotonic() - t0) * 1000
            if wd is not None and elapsed_ms >= 0.9 * timeout_ms:
                flight_recorder.record_wait("bus_barrier", -1, len(ranks), "watchdog", elapsed_ms / 1e3)
                watchdog.dump(f"bus barrier over {sorted(ranks)} stalled >{timeout_ms}ms")
                raise SMPWatchdogTimeout(f"watchdog: bus barrier over {sorted(ranks)} stalled (diagnostics dumped).")
            flight_recorder.record_wait("bus_barrier", -1, len(ranks), "error", elapsed_ms / 1e3)
            raise OSError(f"bus barrier over {sorted(ranks)} failed")
        flight_recorder.record_wait("bus_barrier", -1, len(ranks), "ok", time.monotonic() - t0)

    def shutdown(self):
        self._lib.smp_bus_shutdown()
        self._connected = False


class NativeTimeline:
    """ctypes face of the native timeline recorder."""

    def __init__(self, lib, path):
        self._lib = lib
        self._handle = lib.smp_create_timeline(path.encode())

    def start_step(self, step):
        self._lib.smp_timeline_start_step(self._handle, step)

    def end_step(self, step):
        return self._lib.smp_timeline_end_step(self._handle, step)

    def record_event(self, name, begin_us, end_us, microbatch=None, track="pipeline"):
        self._lib.smp_timeline_record_pipeline_event(
            self._handle, name.encode(), begin_us, end_us, -1 if microbatch is None else microbatch, track.encode(),
        )

    def record_instant(self, name, ts_us, track="pipeline"):
        self._lib.smp_timeline_record_instant(self._handle, name.encode(), ts_us, track.encode())

    def flush(self, pid=0):
        return self._lib.smp_timeline_flush(self._handle, pid)

    def event_count(self):
        return self._lib.smp_timeline_event_count(self._handle)

    def close(self):
        if self._handle:
            self._lib.smp_destroy_timeline(self._handle)
            self._handle = None
