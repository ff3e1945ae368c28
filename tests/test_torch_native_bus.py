"""The port's native host runtime: its build of ``native/src/*.cc`` and the
ctypes faces of the message bus and the timeline recorder.

The cases of ``tests/test_native.py``, on the port's ``backend/native.py``:
in one process, a self round trip, a receive timeout and ``clean``,
transactions retrieved out of order, ``send_raw``/``drain_bytes``, the
native timeline's round trip and the Python ``Timeline`` on it; in two
processes over TCP on 127.0.0.1, a ring of 64 KB frames, interleaved
transactions to one peer, subgroup and world barriers, and a dead peer
(a hard exit, no bus shutdown) surfacing as ``SMPPeerLost`` on a receive and
on a barrier well inside their timeouts. Also: the library is built into the
port's ``_build/`` and never touches ``native/`` (the JAX package's tracked
``native/libsmptpu.so`` keeps its mtime and bytes through a fresh build).
"""

import hashlib
import json
import multiprocessing as mp
import pickle
import socket

import pytest

from smdistributed_modelparallel_tpu_torch.backend import native


def _bus():
    bus = native.MessageBus(native.load())
    bus.connect(0, 1, [f"127.0.0.1:{bus.listen(0)}"])
    return bus


def test_self_send_roundtrip():
    bus = _bus()
    try:
        payload = pickle.dumps({"hello": [1, 2, 3]})
        bus.send_bytes(0, payload, tx=7)
        assert bus.poll(0, 7) and not bus.poll(0, 8)
        assert pickle.loads(bus.recv_bytes(0, 7, timeout_ms=1000)) == {"hello": [1, 2, 3]}
        assert not bus.poll(0, 7)  # consumed
    finally:
        bus.shutdown()


def test_recv_timeout_and_clean():
    bus = _bus()
    try:
        with pytest.raises(TimeoutError):
            bus.recv_bytes(0, 99, timeout_ms=50)
        bus.send_bytes(0, b"x", tx=5)
        bus.clean(0, 5)
        assert not bus.poll(0, 5)
    finally:
        bus.shutdown()


def test_out_of_order_transactions():
    bus = _bus()
    try:
        for tx in (3, 1, 2):
            bus.send_bytes(0, str(tx).encode(), tx=tx)
        assert [bus.recv_bytes(0, tx, 1000) for tx in (2, 3, 1)] == [b"2", b"3", b"1"]
    finally:
        bus.shutdown()


def test_send_raw_and_drain_bytes_self():
    bus = _bus()
    try:
        assert bus.send_raw(0, b"1:7", -4) == 0
        assert bus.send_raw(0, b"2:8", -4) == 0
        assert bus.drain_bytes(0, -4) == [b"1:7", b"2:8"]
        assert bus.drain_bytes(0, -4) == []
        assert not bus.peer_down(0)
    finally:
        bus.shutdown()


def test_native_timeline_roundtrip(tmp_path):
    path = str(tmp_path / "trace.json")
    tl = native.NativeTimeline(native.load(), path)
    tl.start_step(0)
    tl.record_event("fwd_mb0", 10.0, 25.5, microbatch=0)
    tl.record_event("bwd_mb0", 30.0, 55.0, microbatch=0, track="bwd")
    tl.record_instant("step_0_end", 60.0)
    tl.end_step(0)
    assert tl.event_count() == 3
    assert tl.flush(pid=42) == 3
    events = json.loads(open(path).read())["traceEvents"]
    by_name = {e["name"]: e for e in events}
    assert len(events) == 3
    assert by_name["fwd_mb0"]["dur"] == pytest.approx(15.5)
    assert by_name["fwd_mb0"]["args"] == {"microbatch": 0, "step": 0}
    assert by_name["bwd_mb0"]["tid"] == "bwd"
    assert by_name["step_0_end"]["ph"] == "i"
    assert all(e["pid"] == 42 for e in events)
    tl.close()


def test_python_timeline_uses_native(tmp_path, monkeypatch):
    from smdistributed_modelparallel_tpu_torch.utils.timeline import Timeline

    path = str(tmp_path / "t.json")
    monkeypatch.setenv("SMP_TIMELINE_PATH", path)
    tl = Timeline()
    assert tl.enabled and tl._native is not None
    tl.start_step(3)
    with tl.span("phase", microbatch=1):
        pass
    tl.end_step(3)
    tl.flush()
    names = [e["name"] for e in json.loads(open(path).read())["traceEvents"]]
    assert "phase" in names and "step_3_begin" in names and names[0].startswith("smp_clock_anchor/")


def test_build_lands_in_the_port_and_leaves_native_alone(tmp_path, monkeypatch):
    tracked = native.NATIVE_SRC.parent / "libsmptpu.so"
    before = (tracked.stat().st_mtime_ns, hashlib.sha256(tracked.read_bytes()).hexdigest())
    assert native.LIB_PATH.parent.name == "_build" and native.LIB_PATH.exists()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libsmptpu.so")
    assert native._stale() and native._build() and not native._stale()
    assert (tmp_path / "libsmptpu.so").stat().st_size > 0
    assert (tracked.stat().st_mtime_ns, hashlib.sha256(tracked.read_bytes()).hexdigest()) == before


def test_disable_native_turns_the_library_off(monkeypatch):
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("SMP_DISABLE_NATIVE", "1")
    assert native.load() is None and not native.available()


# ---------------------------------------------------------------------------
# two processes over TCP


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _mesh_worker(rank, world, ports, conn):
    from smdistributed_modelparallel_tpu_torch.backend import native as nat

    bus = nat.MessageBus(nat.load())
    bus.listen(ports[rank])
    bus.connect(rank, world, [f"127.0.0.1:{p}" for p in ports])
    try:
        blob = bytes([rank]) * (64 * 1024)
        bus.send_bytes((rank + 1) % world, blob, tx=101)
        assert bus.recv_bytes((rank - 1) % world, 101, timeout_ms=30000) == bytes([(rank - 1) % world]) * 65536
        for tx in range(10):
            bus.send_bytes(0, f"{rank}:{tx}".encode(), tx=1000 + tx)
        if rank == 0:
            for src in range(world):
                for tx in range(10):
                    assert bus.recv_bytes(src, 1000 + tx, timeout_ms=30000) == f"{src}:{tx}".encode()
        for _ in range(3):
            if rank == 0:
                bus.barrier([0], timeout_ms=30000)
            bus.barrier(list(range(world)), timeout_ms=30000)
        conn.send(("ok", rank))
    except Exception as e:  # surfaced in the parent
        conn.send(("err", f"rank {rank}: {type(e).__name__}: {e}"))
    finally:
        bus.shutdown()


def _dead_peer_victim(rank, world, ports, conn):
    """Rank 0: one frame from rank 1, then rank 1's death raises
    SMPPeerLost on a receive and on a barrier, fast."""
    import time

    from smdistributed_modelparallel_tpu_torch.backend import native as nat
    from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPPeerLost

    bus = nat.MessageBus(nat.load())
    bus.listen(ports[rank])
    bus.connect(rank, world, [f"127.0.0.1:{p}" for p in ports])
    try:
        assert bus.recv_bytes(1, 500, timeout_ms=30000) == b"hello"
        bus.send_bytes(1, b"ack", 502)  # rank 1 dies only once its frame is here
        t0 = time.monotonic()
        with_peer = []
        for wait in (lambda: bus.recv_bytes(1, 501, timeout_ms=30000),
                     lambda: bus.barrier([0, 1], timeout_ms=30000)):
            try:
                wait()
                conn.send(("err", "a wait on the dead peer returned"))
                return
            except SMPPeerLost as e:
                with_peer.append(e.peer)
        elapsed = time.monotonic() - t0
        assert with_peer == [1, 1] and bus.peer_down(1) and elapsed < 15, (with_peer, elapsed)
        conn.send(("ok", rank))
    except Exception as e:  # surfaced in the parent
        conn.send(("err", f"rank {rank}: {type(e).__name__}: {e}"))
    finally:
        bus.shutdown()


def _dead_peer_casualty(rank, world, ports, conn):
    """Rank 1: one frame, then, once rank 0 has it, a hard exit with no bus
    shutdown. (Exiting a fixed time after the send loses the frame when rank
    0 starts slowly: the sender thread had not connected yet.)"""
    import os
    import time

    from smdistributed_modelparallel_tpu_torch.backend import native as nat

    bus = nat.MessageBus(nat.load())
    bus.listen(ports[rank])
    bus.connect(rank, world, [f"127.0.0.1:{p}" for p in ports])
    bus.send_bytes(0, b"hello", 500)
    bus.recv_bytes(0, 502, timeout_ms=60000)
    time.sleep(1.0)
    conn.send(("ok", rank))
    os._exit(0)


def _spawn(targets):
    ctx = mp.get_context("spawn")
    ports = _free_ports(len(targets))
    parents, procs = [], []
    for rank, target in enumerate(targets):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=target, args=(rank, len(targets), ports, child), daemon=True)
        p.start()
        child.close()
        parents.append(parent)
        procs.append(p)
    results = []
    try:
        for parent in parents:
            assert parent.poll(120), "worker timed out"
            results.append(parent.recv())
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return results


def test_two_process_mesh():
    results = _spawn([_mesh_worker, _mesh_worker])
    assert all(r[0] == "ok" for r in results), results


def test_dead_peer_raises_peer_lost():
    results = _spawn([_dead_peer_victim, _dead_peer_casualty])
    assert all(r[0] == "ok" for r in results), results
