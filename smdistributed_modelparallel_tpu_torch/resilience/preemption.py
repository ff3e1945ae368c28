"""Preemption-aware emergency checkpointing of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/resilience/preemption.py``,
with the same env vars, reserved tx ids, metric and ring events. At world
size 1 there is no peer bus (``_peer_bus()`` is None), so the notice, the
rendezvous and the step exchange are skipped, as in the JAX package. At world
> 1 they run over ``state.bus``, the native bus ``smp.init`` brings up
(``poll``, ``send_bytes``, ``recv_bytes``, ``barrier``, ``rank``, ``world``),
and the step edge first agrees over the default group whether any rank was
preempted (``agree_at_edge``: the port's step runs its collectives eagerly,
and a rank must not enter the next step's all-reduce while a peer waits in
the rendezvous). The emergency save goes through the port's
``save_checkpoint``.

Cloud GPU instances get maintenance events and spot preemptions as a matter
of course: the platform delivers SIGTERM (or touches a sentinel file) and
kills the host some grace period later. The reference library has no story
for this — a preempted run loses everything since its last scheduled
checkpoint. This module turns the grace period into a *coordinated
emergency partial checkpoint*:

1. **Listen**: ``install()`` (run at ``smp.init``) chains a SIGTERM
   handler and notes the ``SMP_PREEMPTION_FILE`` sentinel path. Either
   trigger flips a process-local flag; nothing else happens in signal
   context (async-signal-safe by construction: set a bool, record a
   timestamp).
2. **Detect at the step edge**: the step engine calls
   ``maybe_emergency_save()`` after every completed step — a flag test
   plus (when configured) one ``os.stat`` of the sentinel. A rank whose
   flag flipped also posts a best-effort preempt notice to every peer on
   the native bus (reserved tx ``-2``, next to the exit-status relay's
   ``-1``) so a *single-rank* SIGTERM still converges: peers poll the
   notice at their own step edges.
3. **Rendezvous + save**: all ranks drain pending async saves, meet at a
   grace-bounded HOST-bus barrier (never a device collective — a peer
   still blocked inside a step's kernels cannot join one, and a device sync
   is uninterruptible; a bus barrier it never joins just times out and
   the save degrades to an uncoordinated best-effort one), and agree on
   the save edge — the MAXIMUM step edge across ranks. A rank whose trigger fired
   at an earlier edge than its slowest-to-know peer (the single-rank
   SIGTERM whose bus notice lands after the peer's same-numbered edge
   passed) would otherwise contribute shards from a different
   optimization step; instead it defers, keeps training to the agreed
   edge, and writes there. Every rank then writes one blocking partial
   checkpoint through the normal ``save_checkpoint`` machinery — the
   single-commit protocol already guarantees ``newest`` moves only after
   every rank's shards are on disk. The commit wait is bounded by
   ``SMP_PREEMPTION_GRACE_SECONDS`` (default 60): better a missing
   ``newest`` than a torn pointer published as the platform's axe falls.
4. **Exit**: by default the process then exits 0 (the SIGTERM was
   honored, on our schedule). Training loops that want to keep running
   (tests, custom supervisors) set ``preemption.exit_after_save = False``.
   A SECOND SIGTERM while the first is still deferred restores the
   previous disposition and re-raises — an insisting sender (impatient
   platform, operator double-kill) terminates the process instead of
   being silently swallowed; ``smp.shutdown`` likewise uninstalls the
   handler so a finished run dies normally on TERM.

Resuming is plain ``smp.resume_from_checkpoint(<SMP_EMERGENCY_CKPT_PATH>)``
— elastic by default, so the restarted job may come back on a *different*
topology (see ``resilience/elastic.py``).
"""

import os
import signal
import sys
import threading
import time

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_preemption

logger = get_logger()

PREEMPTION_FILE_ENV = "SMP_PREEMPTION_FILE"
GRACE_ENV = "SMP_PREEMPTION_GRACE_SECONDS"
EMERGENCY_PATH_ENV = "SMP_EMERGENCY_CKPT_PATH"
DEFAULT_EMERGENCY_PATH = "smp_emergency_ckpt"

# Reserved bus transaction ids for the preemption protocol. Control txs
# live at -1..-33: non-negative ids are the P2P streams (user odd,
# framework even), the exit-status relay owns -1 (backend/core.py), and
# barrier ids start below -33 (the +16 namespace offset in
# message_bus.cc's Barrier keeps them clear of this range).
PREEMPT_NOTICE_TX = -2
STEP_EXCHANGE_TX = -3


def grace_seconds():
    try:
        return float(os.environ.get(GRACE_ENV, "60") or 60)
    except ValueError:
        return 60.0


class PreemptionListener:
    """Process-local preemption state + the emergency-save driver."""

    def __init__(self):
        self._requested = None        # reason string once triggered
        self._requested_at = None     # time.monotonic() of the trigger
        self._prev_sigterm = None
        self._installed = False
        self._sigterm_seen = False
        self._notified_peers = False
        self._saving = False
        self._save_at_step = None     # deferred-save target edge (skew)
        self._deferred = None         # (path, tag, reason) while deferred
        self.emergency_saved = None   # (path, tag) after a successful save
        self.exit_after_save = True
        self._lock = threading.Lock()

    # -- trigger sources ------------------------------------------------

    def install(self):
        """Chain the SIGTERM handler. Idempotent; only possible from the
        main thread (signal module restriction) — elsewhere the sentinel
        file / peer notice remain as triggers."""
        if self._installed:
            return True
        try:
            prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            logger.warning(
                "preemption listener: not on the main thread; SIGTERM "
                "handling disabled (sentinel-file polling still active)."
            )
            return False
        # This listener's own handler, left installed by another handler's
        # uninstall that restored it, is no previous handler: chaining to it
        # would turn one SIGTERM into the second-TERM path, forever.
        self._prev_sigterm = None if prev == self._on_sigterm else prev
        self._installed = True
        return True

    def uninstall(self):
        if not self._installed:
            return
        try:
            signal.signal(signal.SIGTERM, self._prev_sigterm or signal.SIG_DFL)
        except (ValueError, TypeError):
            pass
        self._installed = False
        self._prev_sigterm = None

    def _on_sigterm(self, signum, frame):
        # Signal context: set state only. The actual work happens at the
        # next step edge, outside signal context.
        if self._sigterm_seen:
            # Second SIGTERM while the first is still deferred: the sender
            # is insisting (impatient platform, operator double-kill).
            # Restore the previous disposition and re-raise so the process
            # actually dies — deferral must not turn into swallowing every
            # TERM a hung process will ever receive.
            self._installed = False
            try:
                signal.signal(
                    signal.SIGTERM, self._prev_sigterm or signal.SIG_DFL
                )
            except (ValueError, TypeError):
                return
            os.kill(os.getpid(), signal.SIGTERM)
            return
        self._sigterm_seen = True
        if self._requested is None:
            self._requested = "sigterm"
            self._requested_at = time.monotonic()
        prev = self._prev_sigterm
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    def trigger(self, reason="api"):
        """Programmatic trigger (platform integrations, tests)."""
        if self._requested is None:
            self._requested = reason
            self._requested_at = time.monotonic()

    def _sentinel_path(self):
        return os.environ.get(PREEMPTION_FILE_ENV) or None

    @staticmethod
    def _peer_bus():
        """The live multi-process native bus, or None. Never raises — the
        preemption paths are all best-effort against a dead bus."""
        try:
            from smdistributed_modelparallel_tpu_torch.backend.state import state

            bus = state.bus
            if bus is None or bus.world <= 1:
                return None
            return bus
        except Exception:
            return None

    def _poll_peers(self):
        """Best-effort: has any peer posted a preempt notice? Never raises
        and never blocks — a dead bus must not take the step loop down."""
        bus = self._peer_bus()
        if bus is None:
            return False
        try:
            for peer in range(bus.world):
                if peer != bus.rank and bus.poll(peer, PREEMPT_NOTICE_TX):
                    # CONSUME the frame: a notice left in the inbox would
                    # re-trigger a fresh preemption after reset() in the
                    # continue-without-exit flow (supervisors, tests).
                    try:
                        bus.recv_bytes(peer, PREEMPT_NOTICE_TX, timeout_ms=0)
                    except Exception:
                        pass
                    return True
        except Exception:
            return False
        return False

    def check(self):
        """Current preemption reason, or None. Cheap enough for a per-step
        call: a flag test, one optional stat, and (multi-process, bus up)
        one local poll per peer."""
        if self._requested is not None:
            return self._requested
        sentinel = self._sentinel_path()
        if sentinel and os.path.exists(sentinel):
            self._requested = "sentinel_file"
            self._requested_at = time.monotonic()
            return self._requested
        if self._poll_peers():
            self._requested = "peer_notice"
            self._requested_at = time.monotonic()
            return self._requested
        return None

    @property
    def requested(self):
        return self.check() is not None

    # -- cross-rank propagation -----------------------------------------

    def _notify_peers(self):
        """Post the preempt notice to every peer (reserved tx; one shot).
        Best-effort: peers discovering the preemption via their own signal
        or the sentinel file don't need it."""
        if self._notified_peers:
            return
        self._notified_peers = True
        bus = self._peer_bus()
        if bus is None:
            return
        for peer in range(bus.world):
            if peer == bus.rank:
                continue
            # Per-peer isolation: one dead peer (SMPPeerLost after the
            # retry budget) must not abort notification of the others —
            # they still need to reach the rendezvous.
            try:
                bus.send_bytes(peer, b"preempt", PREEMPT_NOTICE_TX)
            except Exception as e:
                logger.warning(
                    "preempt notice to process %d failed: %s", peer, e
                )

    # -- the emergency save ---------------------------------------------

    def _world_size(self):
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        if not state.initialized:
            return 1
        return state.world_size

    def _remaining_grace(self):
        """Seconds left of the platform's grace budget, floored at 5s so
        even a late discovery gets one real attempt at each bounded wait."""
        grace = grace_seconds()
        elapsed = (
            time.monotonic() - self._requested_at
            if self._requested_at is not None else 0.0
        )
        return max(5.0, grace - elapsed)

    def _bus_rendezvous(self, deadline_s):
        """Meet every process at a step edge over the host bus (bounded by
        ``deadline_s``) and exchange step edges. Returns the per-process
        step-count list, or None when the rendezvous could not complete —
        a peer wedged mid-step never arrives at the bus barrier, the
        barrier times out, and the caller degrades to an uncoordinated
        save instead of hanging past the platform's deadline."""
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        bus = self._peer_bus()
        if bus is None:
            return None
        timeout_ms = max(int(deadline_s * 1000), 1000)
        step = state.step_count
        try:
            bus.barrier(list(range(bus.world)), timeout_ms=timeout_ms)
            # All ranks are now at a step edge: exchange the edges. (The
            # post-barrier recv is effectively instant — every peer sends
            # right after leaving the same barrier.)
            payload = str(step).encode()
            steps = [step] * bus.world
            for peer in range(bus.world):
                if peer != bus.rank:
                    bus.send_bytes(peer, payload, STEP_EXCHANGE_TX)
            for peer in range(bus.world):
                if peer != bus.rank:
                    steps[peer] = int(
                        bus.recv_bytes(
                            peer, STEP_EXCHANGE_TX, timeout_ms=timeout_ms
                        )
                    )
            return steps
        except Exception as e:
            logger.error("preemption bus rendezvous failed: %s", e)
            return None

    def agree_at_edge(self):
        """At world > 1, the step edge's agreement, before
        ``maybe_emergency_save``: one all-reduce (max) of a flag over the
        default ``torch.distributed`` group (gloo, a host integer), so that a
        preemption any rank saw (its SIGTERM, its sentinel file, a peer's
        notice) stops every rank at this same edge. Without it a rank that
        waits in the bus rendezvous and a rank that already waits in the next
        step's gradient all-reduce would wait on each other. A rank that
        learns of a peer's preemption here takes the peer's notice off the
        bus (tx -2; the peer posts it as its save starts), so its reason is
        ``peer_notice`` as in the JAX package."""
        import torch
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return
        if self._save_at_step is not None or self.emergency_saved:
            return
        local = self.check() is not None
        flag = torch.tensor([int(local)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if not flag.item() or local:
            return
        deadline = time.monotonic() + min(grace_seconds(), 10.0)
        while not self._poll_peers() and self._peer_bus() is not None and time.monotonic() < deadline:
            time.sleep(0.002)
        self._requested = "peer_notice"
        self._requested_at = time.monotonic()

    def maybe_emergency_save(self):
        """Step-engine edge hook: no-op until a preemption trigger fires,
        then runs the coordinated emergency save exactly once. Returns the
        (path, tag) of the committed checkpoint, or None (including while
        a skewed rendezvous is converging on its agreed save edge)."""
        if self._save_at_step is not None:
            from smdistributed_modelparallel_tpu_torch.backend.state import state

            if state.step_count < self._save_at_step:
                return None
            return self._deferred_save()
        reason = self.check()
        if reason is None or self._saving or self.emergency_saved:
            return None
        return self.emergency_save(reason=reason)

    def emergency_save(self, path=None, tag=None, reason="api"):
        """Drain, rendezvous on a common save edge, and write one blocking
        partial checkpoint; then (by default) exit the process cleanly."""
        # NOTE: smp.checkpoint (the remat API) shadows the checkpoint
        # MODULE as a package attribute: import the functions directly.
        from smdistributed_modelparallel_tpu_torch.checkpoint import (
            wait_for_checkpoints,
        )
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        with self._lock:
            if self._saving or self.emergency_saved:
                return self.emergency_saved
            self._saving = True
        from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput

        grace = grace_seconds()
        path = path or os.environ.get(EMERGENCY_PATH_ENV) or DEFAULT_EMERGENCY_PATH
        record_preemption("requested", step=state.step_count, detail=reason)
        logger.warning(
            "PREEMPTION (%s): writing emergency checkpoint under %s "
            "(grace %.0fs).", reason, path, grace,
        )
        self._notify_peers()
        try:
            # Everything from the trigger to the committed emergency
            # checkpoint is preemption drain in the goodput ledger (the
            # blocking shard write inside nests as ckpt_save).
            drain_scope = goodput.scope("preempt_drain")
            drain_scope.__enter__()
            # In-flight async saves first: they hold the single saver
            # thread, and their shards may be half-written — the emergency
            # save must not interleave with them.
            try:
                wait_for_checkpoints()
            except Exception as e:
                logger.error("pending async save failed pre-preemption: %s", e)
            # Rendezvous: every rank reaches a step edge before anyone
            # writes — the emergency checkpoint must be ONE consistent
            # step, not a mix of step N and N+1 trees. The rendezvous runs
            # over the native HOST bus with a grace-bounded timeout, never
            # the device collectives (torch.distributed barriers /
            # all-gathers): a peer still blocked INSIDE a step's kernels
            # cannot join a device collective, and a device sync is not
            # interruptible from Python — the triggered rank would hang
            # past the platform's deadline with nothing on disk. A bus
            # rendezvous a wedged peer never joins just times out, and the
            # save degrades to an uncoordinated best-effort one.
            record_preemption("rendezvous", step=state.step_count)
            if self._world_size() > 1:
                steps = self._bus_rendezvous(self._remaining_grace())
                if steps is None:
                    record_preemption(
                        "rendezvous_degraded", step=state.step_count
                    )
                    logger.error(
                        "Preemption rendezvous failed (peer wedged mid-step "
                        "or bus down); writing this rank's emergency shards "
                        "uncoordinated. `newest` still only moves if every "
                        "rank's shards land within the commit wait."
                    )
                elif state.step_count < max(steps):
                    # A rank preempted alone may reach this edge BEHIND
                    # peers that discovered the trigger one step edge later
                    # (the bus notice landed after their same-numbered edge
                    # had already passed). Mixed-step shards would resume
                    # cleanly and be silently WRONG, so the ranks agree on
                    # the MAXIMUM edge: anyone behind it defers — keeps
                    # training, writes its shards when its own edge reaches
                    # the target. The commit (`newest`) waits for every
                    # rank's shards either way.
                    target = max(steps)
                    self._save_at_step = target
                    self._deferred = (path, tag, reason)
                    record_preemption(
                        "deferred", step=state.step_count,
                        detail=f"target={target}",
                    )
                    logger.warning(
                        "Preemption rendezvous: ranks sit at different step "
                        "edges (%s); deferring this rank's emergency shards "
                        "from edge %d to the agreed edge %d.",
                        steps, state.step_count, target,
                    )
                    return None
            tag = tag or f"preempt_step_{state.step_count}"
            return self._write_emergency_checkpoint(path, tag, reason)
        except Exception as e:
            record_preemption("failed", step=state.step_count, detail=str(e))
            logger.error("emergency checkpoint failed: %s", e)
            raise
        finally:
            drain_scope.__exit__(None, None, None)
            self._saving = False

    def _deferred_save(self):
        """Second half of a skewed rendezvous: this rank has now trained to
        the agreed edge; write its shards (the peers that were already
        there wrote theirs and are blocked in the commit wait)."""
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        with self._lock:
            if self._saving or self.emergency_saved:
                return self.emergency_saved
            self._saving = True
        path, tag, reason = self._deferred
        try:
            tag = tag or f"preempt_step_{state.step_count}"
            return self._write_emergency_checkpoint(path, tag, reason)
        except Exception as e:
            record_preemption("failed", step=state.step_count, detail=str(e))
            logger.error("emergency checkpoint failed: %s", e)
            raise
        finally:
            self._saving = False
            self._save_at_step = None
            self._deferred = None

    def _write_emergency_checkpoint(self, path, tag, reason):
        from smdistributed_modelparallel_tpu_torch.checkpoint import save_checkpoint
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        # Bound the commit wait by the REMAINING grace budget (the drain
        # and rendezvous already spent part of it since the trigger): a
        # peer that dies mid-save must not wedge the survivors past the
        # platform's deadline (they'd be killed without even a partial
        # dir). Floor of 5s: a late discovery still gets one real commit
        # attempt.
        remaining = self._remaining_grace()
        prev_timeout = os.environ.get("SMP_CKPT_COMMIT_TIMEOUT")
        os.environ["SMP_CKPT_COMMIT_TIMEOUT"] = str(remaining)
        try:
            save_checkpoint(
                path, tag=tag, partial=True, blocking=True,
                user_content={
                    "preemption_reason": reason,
                    "step_count": state.step_count,
                },
            )
        finally:
            if prev_timeout is None:
                os.environ.pop("SMP_CKPT_COMMIT_TIMEOUT", None)
            else:
                os.environ["SMP_CKPT_COMMIT_TIMEOUT"] = prev_timeout
        # Non-committer ranks return from save_checkpoint as soon as their
        # own shards (and .done marker) are on disk; hold them here until
        # process 0 publishes .committed (or the grace budget runs out) so
        # no rank tears down its runtime while a deferred peer still needs
        # the world to finish training to the agreed edge, and so exit
        # order never races the commit.
        self._await_commit(path, tag)
        self.emergency_saved = (path, tag)
        record_preemption("saved", step=state.step_count, detail=tag)
        logger.warning(
            "Emergency checkpoint '%s' committed under %s.", tag, path
        )
        self._drain_peer_notices()
        if self.exit_after_save:
            logger.warning("Exiting after emergency checkpoint (preemption).")
            sys.exit(0)
        return self.emergency_saved

    def _await_commit(self, path, tag):
        """Block a non-committer rank until ``.committed`` lands (bounded
        by the remaining grace). Process 0 publishes the marker itself; a
        single-process world is its own committer."""
        from smdistributed_modelparallel_tpu_torch.checkpoint import _process_index

        if self._world_size() <= 1 or _process_index() == 0:
            return
        marker = os.path.join(path, f"{tag}_partial", ".committed")
        deadline = time.monotonic() + self._remaining_grace()
        while not os.path.exists(marker):
            if time.monotonic() > deadline:
                logger.error(
                    "emergency checkpoint '%s': commit marker did not land "
                    "within the grace budget; exiting without it (the "
                    "platform's deadline is imminent).", tag,
                )
                return
            time.sleep(0.05)

    def _drain_peer_notices(self):
        """Best-effort: consume preemption-protocol frames still queued
        from peers — each rank posts a notice to EVERYONE, so a rank that
        triggered on its own signal has its peers' echoes sitting unread
        in its inbox, and the continue-without-exit flow (supervisors,
        tests) would re-trigger on the stale frame right after
        ``reset()``. Step-exchange frames from an aborted rendezvous are
        drained too so a later rendezvous never reads a stale edge.
        Frames still in flight can slip past this; ``reset()`` drains
        again."""
        bus = self._peer_bus()
        if bus is None:
            return
        try:
            for peer in range(bus.world):
                if peer == bus.rank:
                    continue
                for tx in (PREEMPT_NOTICE_TX, STEP_EXCHANGE_TX):
                    while bus.poll(peer, tx):
                        try:
                            bus.recv_bytes(peer, tx, timeout_ms=0)
                        except Exception:
                            break
        except Exception:
            pass

    def reset(self):
        """Testing hook: clear triggers and save state (handler stays)."""
        self._requested = None
        self._requested_at = None
        self._sigterm_seen = False
        self._notified_peers = False
        self._saving = False
        self._save_at_step = None
        self._deferred = None
        self.emergency_saved = None
        self.exit_after_save = True
        self._drain_peer_notices()


preemption = PreemptionListener()
