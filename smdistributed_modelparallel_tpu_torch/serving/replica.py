"""Serving-replica failover (``smp.serving.ReplicatedServingEngine``).

Counterpart of ``smdistributed_modelparallel_tpu/serving/replica.py``. Each
process of a multi-process serving deployment runs its own ``ServingEngine``
on its own card and MIRRORS every in-flight request's restartable log
(prompt, sampling parameters, seed, the tokens sampled so far) to its peers
over the native bus (reserved control tx ``SERVE_MIRROR_TX`` = -6, the quiet
``send_raw`` path heartbeats use). The first frame of a request ships its
whole record, later ones the token tail since the last (``base``).

Failure detection rides the supervisor: with ``SMP_SUPERVISOR=on`` the
heartbeat detector classifies a SIGKILLed replica dead within its miss
budget; without it, the bus's receive-side death marks (``peer_down``) carry
the signal (``supervisor.classify_failed``). Either way the survivor
re-admits the dead replica's unfinished requests from its mirror shadow,
idempotently by request id and exactly: a resumed request continues the dead
replica's key schedule at ``len(tokens_so_far)``, so the survivor emits the
tokens the dead replica would have.

A completed failover records ``smp_recoveries_total`` /
``smp_recovery_seconds`` with the serving phases ``detect`` (last mirror
frame -> classification, capped by the detector's window when it runs),
``readmit`` (shadow scan and re-admission) and ``first_token`` (the first
re-admitted token sampled), which ``scripts/resilience_probe.py --recovery``
reads.
"""

import json
import time

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.serving.engine import (
    serve_request_from_record,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    record_failure_detected,
    record_recovery,
    record_serve_request,
)

logger = get_logger()

#: Reserved control tx for serving mirror frames (-1 exit relay, -2
#: preempt notice, -3 preempt step-edge, -4 heartbeats, -5 recovery
#: rendezvous, -7 fleet metric snapshots, -8 controller/router frames —
#: see backend/native.py and serving/router.py).
SERVE_MIRROR_TX = -6


def _flight():
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import (
        flight_recorder,
    )

    return flight_recorder


class ReplicatedServingEngine:
    """Failover wrapper around a local ``ServingEngine``."""

    def __init__(self, engine, bus=None):
        self.engine = engine
        if bus is None:
            bus = state.bus
        if bus is None or bus.world <= 1:
            raise ValueError(
                "ReplicatedServingEngine needs a multi-process native bus "
                "(replica failover is between processes)."
            )
        self.bus = bus
        self.rank = bus.rank
        self.peers = [p for p in range(bus.world) if p != bus.rank]
        self.shadow = {p: {} for p in self.peers}   # peer -> rid -> record
        self._last_frame = {p: time.monotonic() for p in self.peers}
        self._handled = set()                        # peers failed over
        # Per-peer pending MTTR closures: concurrent failovers (3+
        # replicas, two deaths in one window) each record their own
        # recovery with their own re-admitted streams.
        self._pending_mttr = {}                      # peer -> pending
        self._sent_tokens = {}   # rid -> tokens already mirrored out

    # -- mirror plane ---------------------------------------------------
    #
    # Wire format: the FIRST frame for a request ships the full
    # restartable record; every later frame ships only the token tail
    # since the last send ({"rid", "base", "tokens", "done"}). The bus
    # delivers in order per link, so the receiver reconstructs by
    # appending at ``base`` — without the delta form, a long stream
    # re-serializes its whole history every token (O(n^2) per stream).

    def _mirror_out(self):
        updates = self.engine.drain_dirty()
        if not updates:
            return
        wire = []
        for rid, rec in updates:
            sent = self._sent_tokens.get(rid)
            if sent is None or sent > len(rec["tokens"]):
                wire.append(dict(rec, full=True))
            else:
                wire.append({
                    "rid": rid, "base": sent,
                    "tokens": rec["tokens"][sent:],
                    "done": rec["done"],
                })
            self._sent_tokens[rid] = len(rec["tokens"])
        payload = json.dumps(
            {"from": self.rank, "records": wire}
        ).encode()
        for p in self.peers:
            if p in self._handled:
                continue
            # Quiet best-effort enqueue: a dead link's rc is detection
            # signal, not an error — the detector owns classification.
            self.bus.send_raw(p, payload, SERVE_MIRROR_TX)

    def _mirror_in(self):
        now = time.monotonic()
        for p in self.peers:
            frames = self.bus.drain_bytes(p, SERVE_MIRROR_TX)
            if frames:
                self._last_frame[p] = now
            for raw in frames:
                try:
                    frame = json.loads(raw)
                except ValueError:
                    continue
                for rec in frame.get("records", ()):
                    rid = rec.get("rid")
                    if not rid:
                        continue
                    if rec.get("full") or "prompt" in rec:
                        rec = dict(rec)
                        rec.pop("full", None)
                        self.shadow[p][rid] = rec
                        continue
                    known = self.shadow[p].get(rid)
                    if known is None:
                        continue  # never saw the header; cannot apply
                    base = int(rec.get("base", 0))
                    if base <= len(known["tokens"]):
                        known["tokens"] = (
                            known["tokens"][:base] + list(rec["tokens"])
                        )
                        known["done"] = bool(rec.get("done"))

    # -- failure detection + re-admission -------------------------------

    def _failed_peers(self):
        from smdistributed_modelparallel_tpu_torch.resilience.supervisor import (
            classify_failed,
        )

        failed = classify_failed(self.bus, self.peers)
        return {
            p: kind for p, kind in failed.items() if p not in self._handled
        }

    def _failover(self, peer, kind):
        from smdistributed_modelparallel_tpu_torch.resilience.supervisor import (
            heartbeat_interval,
            miss_budget,
            supervisor,
        )

        t0 = time.monotonic()
        # The mirror-frame gap over-reports detection latency for a peer
        # that was idle (nothing dirty = nothing sent); the heartbeat
        # detector's classification window bounds the REAL latency, so
        # cap the phase by it when the detector is armed.
        detect_s = max(t0 - self._last_frame.get(peer, t0), 0.0)
        if supervisor.detector is not None:
            detect_s = min(
                detect_s, heartbeat_interval() * (miss_budget() + 1)
            )
        self._handled.add(peer)
        _flight().record_supervisor(
            "recover_begin", peer=peer,
            detail=f"mode=serving kind={kind}",
        )
        if supervisor.detector is None:
            # No heartbeat detector running (SMP_SUPERVISOR=off): the bus
            # death mark was the classification — count it ourselves.
            record_failure_detected(kind, peer, detail="serving bus probe")
        readmitted = {}
        for rid, rec in sorted(self.shadow[peer].items()):
            if rec.get("done"):
                continue
            # The record carries the dead replica's trace id, so the
            # fused timeline shows one request spanning both rings
            # instead of a new request materializing on the survivor.
            req = serve_request_from_record(rec)
            if self.engine.submit(req):
                readmitted[rid] = len(req.resume_tokens)
                record_serve_request("readmitted")
        t1 = time.monotonic()
        logger.warning(
            "[serving] replica %d is %s: re-admitted %d unfinished "
            "request(s) from the mirror shadow (%.3fs).",
            peer, kind, len(readmitted), t1 - t0,
        )
        pending = {
            "peer": peer,
            "t_detect": t0,
            "detect_s": detect_s,
            "readmit_s": t1 - t0,
            # rid -> token count at re-admission: closure needs progress
            # BEYOND this baseline, not just the resumed prefix.
            "rids": readmitted,
        }
        if readmitted:
            self._pending_mttr[peer] = pending
        else:
            # Nothing in flight died with the replica: close immediately.
            self._close_mttr(pending, first_token_s=0.0)

    def _close_mttr(self, pending, first_token_s):
        self._pending_mttr.pop(pending["peer"], None)
        phases = {
            "detect": pending["detect_s"],
            "readmit": pending["readmit_s"],
            "first_token": first_token_s,
        }
        mttr = sum(phases.values())
        record_recovery(mttr, phases=phases)
        logger.warning(
            "[serving] FAILOVER complete: first re-admitted token %.2fs "
            "after detection (phases: %s).", mttr,
            {k: round(v, 3) for k, v in phases.items()},
        )

    def _check_mttr_closure(self):
        for pending in list(self._pending_mttr.values()):
            for rid, baseline in pending["rids"].items():
                rec = self.engine.mirror_log.get(rid)
                if rec is None:
                    continue
                if len(rec["tokens"]) > baseline or rec["done"]:
                    self._close_mttr(
                        pending,
                        first_token_s=max(
                            time.monotonic() - pending["t_detect"]
                            - pending["readmit_s"], 0.0,
                        ),
                    )
                    break

    # -- driving --------------------------------------------------------

    def step(self):
        """One replicated tick: local engine tick, mirror exchange,
        failover check. Returns True while local work remains."""
        busy = self.engine.step()
        self._mirror_out()
        self._mirror_in()
        for peer, kind in self._failed_peers().items():
            self._failover(peer, kind)
        self._check_mttr_closure()
        return busy or bool(self._pending_mttr)

    def run(self, requests=(), timeout_s=300.0, linger_s=0.0):
        """Serve ``requests`` (plus any failover re-admissions) to
        completion. ``linger_s`` keeps ticking that long after local work
        drains so late peer deaths are still absorbed (the E2E uses it to
        hold the survivor open across the kill window)."""
        for req in requests:
            self.engine.submit(req)
        deadline = time.monotonic() + timeout_s
        linger_until = None
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("replicated serving run timed out")
            busy = self.step()
            if busy:
                linger_until = None
                if not self.engine.last_tick_worked:
                    time.sleep(0.001)  # blocked on arrivals/blocks/MTTR
                continue
            if linger_s <= 0.0:
                break
            if self._handled >= set(self.peers):
                # Every peer already failed over — nothing left to linger
                # for.
                break
            if linger_until is None:
                linger_until = time.monotonic() + linger_s
            elif time.monotonic() >= linger_until:
                break
            time.sleep(0.02)
        return dict(self.engine.results)
