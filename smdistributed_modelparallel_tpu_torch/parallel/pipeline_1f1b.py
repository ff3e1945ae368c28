"""1F1B ("interleaved") pipeline schedule with bounded in-flight
microbatches: the schedule builders and the per-stage 1F1B executor.

Counterpart of ``smdistributed_modelparallel_tpu/parallel/pipeline_1f1b.py``.
The schedule half is the port's own copy of the JAX package's (pure numpy,
array for array the same; ``tests/test_torch_pipeline_schedules.py``):
``build_1f1b_schedule``, ``schedule_occupancy``,
``build_interleaved_1f1b_schedule``, ``interleaved_phase_bounds``,
``build_zero_bubble_schedule``, ``zero_bubble_phase_bounds`` and
``zero_bubble_theoretical_bubble``. The executor here runs the plain v = 1
grid: each rank walks its stage's column of ``build_1f1b_schedule`` (window
``W = min(active_microbatches or S + 1, M)``), a forward sub-step then a
backward sub-step a tick, through ``parallel/pipeline.StageExecutor``. The
interleaved virtual stages and the zero-bubble split backward run in the JAX
package only (ROADMAP item 8).

Parity target: reference ``torch/pipeline.py:136-145``
(``InterleavedPipeline.get_next_microbatch`` prioritizes ready-backwards over
new forwards) and ``torch/server_queue.py:629-676`` (the
``active_microbatches`` in-flight cap).
"""

import numpy as np

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import PartitionError


def build_1f1b_schedule(num_stages, num_microbatches, window):
    """Static lockstep 1F1B schedule.

    Returns (fwd, bwd): int arrays [n_ticks, S]; entry = microbatch index the
    stage processes in that tick's sub-step, or -1 for idle. Invariants: a
    stage's forward of microbatch m runs only after stage s-1's forward of m
    (strictly earlier tick); a stage's backward of m runs only after its own
    forward of m (same tick allowed on the last stage — cotangent comes from
    the loss, not a neighbor) and after stage s+1's backward of m; at most
    ``window`` microbatches are in flight (forwarded, not yet backwarded)
    per stage at any tick.
    """
    S, M, W = num_stages, num_microbatches, window
    if W < 1:
        raise PartitionError(f"active_microbatches must be >= 1, got {W}")
    fwd_next = [0] * S
    bwd_next = [0] * S
    fwd_tick = {}
    bwd_tick = {}
    fwd_rows, bwd_rows = [], []
    t = 0
    limit = 4 * (M + S) * max(1, (S + W - 1) // W) + 16
    while any(b < M for b in bwd_next):
        frow, brow = [-1] * S, [-1] * S
        for s in range(S):
            m = fwd_next[s]
            if m < M and (fwd_next[s] - bwd_next[s]) < W:
                if s == 0 or fwd_tick.get((s - 1, m), limit) < t:
                    frow[s] = m
        for s in range(S):
            if frow[s] >= 0:
                fwd_tick[(s, frow[s])] = t
                fwd_next[s] += 1
        for s in range(S):
            m = bwd_next[s]
            if m < M and fwd_tick.get((s, m), limit) <= t:
                if s == S - 1 or bwd_tick.get((s + 1, m), limit) < t:
                    brow[s] = m
        for s in range(S):
            if brow[s] >= 0:
                bwd_tick[(s, brow[s])] = t
                bwd_next[s] += 1
        fwd_rows.append(frow)
        bwd_rows.append(brow)
        t += 1
        if t > limit:
            raise PartitionError(
                f"1F1B schedule did not converge (S={S}, M={M}, W={W})"
            )
    return np.asarray(fwd_rows, np.int32), np.asarray(bwd_rows, np.int32)


def schedule_occupancy(fwd, bwd, fwd_ticks=None, bwd_ticks=None, wgt=None,
                       wgt_ticks=None):
    """(busy_slots, total_slots) of a static 1F1B schedule.

    Each tick has a forward and a backward sub-step per stage; a sub-slot
    is busy when its schedule entry is a microbatch index (>= 0). The
    compiled program executes exactly this schedule, so this IS the
    measured occupancy. Under virtual pipeline stages the entries are
    (chunk, microbatch) units, so busy counts CHUNK sub-steps (busy ==
    2*S*V*M) and stays comparable across ``virtual_pipeline_degree``
    values; ``fwd_ticks``/``bwd_ticks`` then restrict the denominator to
    the ticks whose sub-step actually executes (the virtual executor's
    warmup ticks are forward-only and its cooldown ticks backward-only —
    idle sub-steps that are never compiled are not bubble).

    Zero-bubble schedules split the backward into input-grad (B) and
    weight-grad (W) passes: ``bwd`` then carries the B pass, ``wgt`` the
    W pass (with its own ``wgt_ticks`` executed-span bound), and busy
    counts (chunk, microbatch, pass) sub-steps — 3*S*V*M when every unit
    ran exactly once.
    """
    busy = int((fwd >= 0).sum()) + int((bwd >= 0).sum())
    if fwd_ticks is None:
        fwd_ticks = int(fwd.shape[0])
    if bwd_ticks is None:
        bwd_ticks = int(bwd.shape[0])
    total_ticks = fwd_ticks + bwd_ticks
    if wgt is not None:
        busy += int((wgt >= 0).sum())
        total_ticks += int(wgt.shape[0]) if wgt_ticks is None else wgt_ticks
    total = int(fwd.shape[1]) * total_ticks
    return busy, total


def build_interleaved_1f1b_schedule(num_stages, num_microbatches, window,
                                    virtual):
    """Static lockstep 1F1B schedule over ``virtual`` chunks per stage.

    Megatron-style virtual pipeline stages: the model is cut into
    ``C = num_stages * virtual`` chunks; global chunk ``c`` lives on stage
    ``c % num_stages`` as that stage's local chunk ``k = c // num_stages``.
    Returns ``(fwd_chunk, fwd_mb, bwd_chunk, bwd_mb)``: int32 arrays
    ``[n_ticks, S]``; per tick each stage processes at most one
    (chunk, microbatch) unit per direction (-1 = idle).

    Invariants (generalizing the v=1 schedule's):
      - every (chunk, microbatch) is forwarded and backwarded exactly once;
      - fwd of chunk c, mb m runs strictly after fwd of chunk c-1, mb m;
      - bwd of chunk c, mb m runs strictly after bwd of chunk c+1, mb m,
        and not before its own fwd (same tick allowed only on the LAST
        chunk, whose cotangent comes from the loss, not a neighbor);
      - per (stage, chunk), at most ``window`` microbatches are in flight
        (forwarded, not yet backwarded) at any tick.

    Greedy policy: each stage picks the highest eligible chunk in both
    directions (depth-first fwd pushes microbatches toward the loss so
    backwards start sooner; highest-chunk bwd drains cotangents down the
    chunk chain). At ``virtual=1`` this reduces EXACTLY to
    ``build_1f1b_schedule`` (one chunk per stage, identical arrays).

    Bubble: with ``window >= 2*num_stages`` the schedule achieves the
    interleaved floor — occupancy over executed sub-steps (forward-only
    warmup ticks + paired ticks + backward-only cooldown ticks, see
    ``interleaved_phase_bounds``) equals
    ``1 - (pp-1)/(v*mb + pp-1)``. The default ``active_microbatches``
    (pp+2) reaches it at pp=2; deeper pipelines trade the last bubble
    fraction against in-flight activation memory.
    """
    S, M, W, V = num_stages, num_microbatches, window, virtual
    if W < 1:
        raise PartitionError(f"active_microbatches must be >= 1, got {W}")
    if V < 1:
        raise PartitionError(f"virtual degree must be >= 1, got {V}")
    C = S * V
    fwd_next = [[0] * V for _ in range(S)]
    bwd_next = [[0] * V for _ in range(S)]
    fwd_tick = {}
    bwd_tick = {}
    fk_rows, fm_rows, bk_rows, bm_rows = [], [], [], []
    t = 0
    limit = 4 * V * (M + S) * max(1, (S + W - 1) // W) + 16 * V

    def fwd_candidate(s):
        """Highest eligible local chunk for stage s's fwd sub-step."""
        for k in range(V - 1, -1, -1):
            c = k * S + s
            m = fwd_next[s][k]
            if m < M and (fwd_next[s][k] - bwd_next[s][k]) < W:
                if c == 0 or fwd_tick.get((c - 1, m), limit) < t:
                    return k, m
        return -1, -1

    def bwd_candidate(s):
        for k in range(V - 1, -1, -1):
            c = k * S + s
            m = bwd_next[s][k]
            if m < M and fwd_tick.get((c, m), limit) <= t:
                if c == C - 1 or bwd_tick.get((c + 1, m), limit) < t:
                    return k, m
        return -1, -1

    while any(n < M for row in bwd_next for n in row):
        fk, fm = zip(*(fwd_candidate(s) for s in range(S)))
        for s in range(S):
            if fm[s] >= 0:
                fwd_tick[(fk[s] * S + s, fm[s])] = t
                fwd_next[s][fk[s]] += 1
        bk, bm = zip(*(bwd_candidate(s) for s in range(S)))
        for s in range(S):
            if bm[s] >= 0:
                bwd_tick[(bk[s] * S + s, bm[s])] = t
                bwd_next[s][bk[s]] += 1
        fk_rows.append(fk)
        fm_rows.append(fm)
        bk_rows.append(bk)
        bm_rows.append(bm)
        t += 1
        if t > limit:
            raise PartitionError(
                f"interleaved 1F1B schedule did not converge "
                f"(S={S}, M={M}, W={W}, V={V})"
            )
    return (np.asarray(fk_rows, np.int32), np.asarray(fm_rows, np.int32),
            np.asarray(bk_rows, np.int32), np.asarray(bm_rows, np.int32))


def interleaved_phase_bounds(fwd_mb, bwd_mb):
    """(t_bwd_start, t_fwd_end) of an interleaved schedule.

    Ticks ``[0, t_bwd_start)`` have no backward work anywhere (warmup:
    the executor compiles them as forward-only sub-steps) and ticks
    ``[t_fwd_end, n_ticks)`` no forward work (cooldown: backward-only).
    This phase split is what realizes the interleaved bubble win: the
    rigidly paired tick (one fwd + one bwd sub-step) would idle a full
    sub-step per warmup/cooldown tick, making the sub-slot bubble
    independent of the virtual degree.
    """
    n_ticks = int(fwd_mb.shape[0])
    bwd_any = (bwd_mb >= 0).any(axis=1)
    fwd_any = (fwd_mb >= 0).any(axis=1)
    t_b0 = int(np.argmax(bwd_any)) if bwd_any.any() else n_ticks
    t_fe = n_ticks - int(np.argmax(fwd_any[::-1])) if fwd_any.any() else 0
    return t_b0, t_fe


def build_zero_bubble_schedule(num_stages, num_microbatches, window,
                               virtual=1):
    """ZB-H1 zero-bubble schedule: (chunk, microbatch, pass) units.

    Splits the backward into an input-gradient pass (B, on the critical
    path: it feeds the upstream stage's cotangent) and a weight-gradient
    pass (W, deferrable: it depends only on the stage's own B), and packs
    the deferred Ws into ticks that the F/B schedule would otherwise
    leave idle — cooldown first. Returns
    ``(fwd_chunk, fwd_mb, bwd_chunk, bwd_mb, wgt_chunk, wgt_mb)``: int32
    arrays ``[n_ticks, S]``, one (chunk, microbatch) unit per stage per
    pass per tick (-1 = idle).

    Invariants (on top of the interleaved schedule's for F and B):
      - every (chunk, microbatch) runs each of F, B, W exactly once;
      - B(c, m) depends on F(c, m) and the downstream B(c+1, m) exactly
        as the interleaved schedule's monolithic backward does — the
        (F, B) sub-schedule here IS ``build_interleaved_1f1b_schedule``'s
        output tick-for-tick (fusing W back into B reproduces it);
      - W(c, m) depends ONLY on B(c, m); the same tick is legal because
        the executor orders sub-steps F -> B -> W within a tick;
      - per stage, at most one W per tick (it is a real compute slot).

    Packing policy: per stage, Ws run FIFO in B-completion order, shifted
    so no stage starts its W run before the LAST stage has started
    backwards (``w_lo = max_s first_B_tick(s)``). Early stages therefore
    defer weight grads into the B-drain cooldown — the ticks where their
    B slot idles waiting for upstream cotangents — instead of fusing them
    into warm B ticks and idling cold ones. At (pp=2, mb >= pp, default
    window) every stage's W run is gapless and the sub-slot bubble over
    executed pass spans reaches

        2*(pp-1) / (3*v*mb + 2*(pp-1))

    strictly below the interleaved floor (pp-1)/(v*mb + pp-1) for every
    v, mb (the F and B ramps keep their pp-1 idle sub-slots; the W pass
    contributes zero). The deferral depth this costs is bounded — the
    W-queue ring is accounted by ``parallel/memory.py::
    zero_bubble_ring_plan`` and stays within the existing ``window + 1``
    stash ring at the default window.
    """
    S, M, V = num_stages, num_microbatches, virtual
    fwd_k, fwd_m, bwd_k, bwd_m = build_interleaved_1f1b_schedule(
        S, M, window, V
    )
    n_fb = int(fwd_m.shape[0])
    # Per-stage B completions in tick order (== microbatch FIFO per
    # (stage, chunk): bwd_next only ever increments).
    per_stage = [[] for _ in range(S)]
    for t in range(n_fb):
        for s in range(S):
            if bwd_m[t, s] >= 0:
                per_stage[s].append((t, int(bwd_k[t, s]), int(bwd_m[t, s])))
    firsts = [rows[0][0] for rows in per_stage if rows]
    w_lo = max(firsts) if firsts else 0
    n_ticks = n_fb
    assign = [[] for _ in range(S)]
    for s in range(S):
        prev = -1
        for i, (bt, k, m) in enumerate(per_stage[s]):
            wt = max(w_lo + i, bt, prev + 1)
            prev = wt
            assign[s].append((wt, k, m))
            n_ticks = max(n_ticks, wt + 1)

    def pad(a):
        if n_ticks == a.shape[0]:
            return a
        tail = np.full((n_ticks - a.shape[0], S), -1, np.int32)
        return np.concatenate([a, tail])

    fwd_k, fwd_m, bwd_k, bwd_m = (pad(a) for a in (fwd_k, fwd_m,
                                                   bwd_k, bwd_m))
    wgt_k = np.full((n_ticks, S), -1, np.int32)
    wgt_m = np.full((n_ticks, S), -1, np.int32)
    for s in range(S):
        for wt, k, m in assign[s]:
            wgt_k[wt, s] = k
            wgt_m[wt, s] = m
    return fwd_k, fwd_m, bwd_k, bwd_m, wgt_k, wgt_m


def zero_bubble_phase_bounds(fwd_mb, bwd_mb, wgt_mb):
    """Executed-tick span ``(lo, hi)`` per pass: F, B, W.

    Generalizes ``interleaved_phase_bounds`` to three passes: ticks
    outside a pass's span never compile that pass's sub-step (the ZB
    executor scans per contiguous segment of active passes), so only
    in-span idle sub-slots are bubble. ``(0, 0)`` marks a pass with no
    work (degenerate schedules).
    """

    def span(arr):
        busy = (arr >= 0).any(axis=1)
        if not busy.any():
            return (0, 0)
        lo = int(np.argmax(busy))
        hi = int(arr.shape[0] - np.argmax(busy[::-1]))
        return (lo, hi)

    return span(fwd_mb), span(bwd_mb), span(wgt_mb)


def zero_bubble_theoretical_bubble(num_stages, num_microbatches, virtual=1):
    """ZB-H1 sub-slot bubble bound: 2*(pp-1)/(3*v*mb + 2*(pp-1)).

    Denominator: 3 passes of v*mb busy sub-slots per stage plus the F and
    B ramps' pp-1 extra span ticks each; numerator: those two ramps' idle
    sub-slots (the W pass packs gapless). Strictly below the interleaved
    bound (pp-1)/(v*mb + pp-1) whenever v*mb > 0.
    """
    S, M, V = num_stages, num_microbatches, virtual
    denom = 3 * V * M + 2 * (S - 1)
    return 2 * (S - 1) / denom if denom > 0 else 0.0


def pipeline_1f1b(executor):
    """The 1F1B executor at v = 1: this stage's column of the lockstep grid
    (a forward sub-step, then a backward one, each tick). Records the JAX
    package's occupancy gauges (``1f1b``) and the busy slots in the flight
    recorder. Returns the stage's error, if any (``StageExecutor.run``)."""
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_pipeline_occupancy

    cfg = state.cfg
    S, M = executor.S, cfg.microbatches
    W = min(cfg.active_microbatches or (S + 1), M)
    fwd, bwd = build_1f1b_schedule(S, M, W)
    busy, total = schedule_occupancy(fwd, bwd)
    record_pipeline_occupancy("1f1b", S, M, busy_slots=busy, total_slots=total)
    flight_recorder.record_schedule(
        "1f1b",
        ((t, s, d, int(sched[t, s]))
         for t in range(fwd.shape[0]) for s in range(S)
         for d, sched in (("fwd", fwd), ("bwd", bwd))
         if sched[t, s] >= 0),
    )
    s = executor.s
    return executor.run([(int(f), int(b)) for f, b in zip(fwd[:, s], bwd[:, s])])
