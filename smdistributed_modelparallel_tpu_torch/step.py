"""``@smp.step``: the training-step engine of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/step.py`` (``StepFunction``).
The JAX package traces the whole step
into one compiled program; here the same numbers come from an eager loop:

- the step arguments are split into ``microbatches`` by the
  ``TensorSplitter`` (``backend/split.py``); each microbatch runs the user
  function, in which ``model(...)`` applies the module and
  ``model.backward(loss)`` marks the loss;
- the compute parameters are the fp32 master parameters cast to the
  config's half dtype (every floating parameter, as ``nn/utils.half_cast``
  does), cast once per step; each microbatch's gradient is taken with
  respect to them (so it is rounded to the half dtype, as the JAX
  package's gradient w.r.t. its half-cast parameters is) and accumulated
  in the master dtype (fp32, also when ``_fp32_grad_accumulation`` asks
  for it);
- a microbatch whose model calls ran ``DistributedMoE`` layers
  differentiates its marked loss plus their load-balancing losses times
  ``moe_aux_loss_weight`` (``DistributedModel._end_microbatch``), as the JAX
  package folds its sown ``moe_aux_loss``; the outputs keep the marked loss;
- the sum is divided by ``microbatches * loss_scale`` and cast to each
  parameter's dtype: the mean over microbatches. Under fp16 the loss is
  scaled by the ``DynamicLossScaler`` before differentiation and the
  gradients are checked for overflow; ``DistributedOptimizer.step`` skips
  the update and backs the scale off when they are not finite;
- the outputs are stacked along a leading [microbatches] axis into a
  ``StepOutput``, and ``state.step_count`` advances by one (the step edge a
  checkpoint records).

``fused_optimizer_step`` and ``fused_step_donation`` fuse the optimizer
update into the JAX package's compiled step program (and donate its
buffers). Eager PyTorch has no such program to fuse into, so the port
accepts both keys and keeps what a user observes without them: the
parameters change only at ``optimizer.step()``, and steps that run without
one draw the "NOT learning" warning. (Under ``fused_step_donation`` the JAX
package installs the update at the step itself; a loop that calls
``optimizer.step()`` after every step sees the same parameters in both.)

Random keys, as the JAX step program derives them: the step takes
``state.step_rng`` (on the first step, ``rng_manager.next_key("step")``),
splits it into the key it uses and the next step's (``split(rng)``), splits
the first into one key a microbatch (``split(use, microbatches)``) and folds
the index of each of the model's ``rng_streams`` into the microbatch's key
(``fold_in(key, h)``): the keys ``model(...)`` draws from inside the
microbatch (``nn/utils.make_rng``). The JAX package's first step also runs
an init pass that draws ``init_dropout`` keys; the port has no init pass,
and that stream's counter is apart from "step"'s, so the step keys agree
from the first step on.

Under ``matmul_precision: fp8`` the step installs ``quant.step_trace`` around
the whole microbatch loop (every forward and every ``autograd.grad``): every
microbatch quantizes with the scales the step started with, the seams fold
their amax observations into one running max per slot, and after the last
microbatch ``quant.finalize`` rolls the histories into ``state.quant_state``,
as the JAX step program returns its quant output. An eval-only step (no
``model.backward``) rolls its forward slots the same way.

Context parallelism (``context_parallel_degree`` > 1). Every rank is handed
the full global batch, as the JAX user's code is; after the microbatch split
the step slices dimension 1 (the sequence) of every split input with at least
two dimensions to the rank's contiguous shard, as the JAX package's
``batch_spec`` shards it over cp, and runs the microbatches with
``state.cp_sharded`` set: attention goes over the cp ring (or Ulysses) and
positions start at the shard's offset. The parameters are replicated over cp
(``DistributedModel`` broadcasts them from the group's first rank). After the
last microbatch the accumulated gradients are summed over the cp group in one
flat buffer, so that they are the gradient of the global-mean loss:
  - each rank's loss is a mean over its shard. By default the ranks weigh
    equally (a plain mean over equal shards). A loss that averages over a
    token mask passes its count, ``model.backward(loss, num_tokens=n)``; the
    rank's gradient and loss are then weighted by n over the group's total,
    as the global masked mean weighs them;
  - the ``StepOutput`` leaves are combined over the group: the marked loss
    with those weights, other values of at most one dimension by their mean,
    and values of two or more dimensions (per-token values) gathered along
    dimension 1, the sequence; so ``reduce_mean()`` gives the JAX package's
    global loss;
  - a loss that shifts along the sequence inside the step (``logits[:, :-1]``
    against ``ids[:, 1:]``) cannot be computed on a shard: the last token of a
    shard predicts the first of the next. Under cp the step takes the
    ``(ids, targets)`` form, with targets shifted by the caller before the
    step, as loss mode (``model(ids, targets=...)``) does.
Under cp the step refuses fp16 (the loss scaler's overflow flag would have to
agree across ranks) and ``matmul_precision: fp8`` (amax would need a
cross-rank max).

Data parallelism (rdp > 1, at tp = 1: one replica a rank). The port
follows the JAX package's per-process contract (``utils/data.shard_batches``):
each rank is handed its own rows, rows ``[r*B/R, (r+1)*B/R)`` of the global
stream at rdp rank r, and splits them into its microbatches; microbatch m of
the step is the union over the ranks of their microbatch m. The parameters
are replicated (``DistributedModel`` broadcasts them from the group's first
rank at build), each rank runs its microbatches, and after the last one the
fp32 accumulators are summed over the rdp group in one flat all-reduce and
divided by ``microbatches * rdp``; the loss weights and the ``StepOutput``
combine as under cp (a marked loss weighted by ``num_tokens`` over the
group's total, or equally; values of at most one dimension per microbatch
averaged), except that values of two or more dimensions are per-row and are
gathered along the rows (dimension 1 of the stacked leaf), in rank order. The
JAX package's single-process step groups microbatch m as rows ``[m*B/M,
(m+1)*B/M)`` of the batch it is handed and shards each over rdp; the two agree
on a global batch laid out microbatch-major (row ``m*B/M + r*b + i`` of the
JAX batch is row ``r*B/R + m*b + i`` of the stream, ``b = B/(M*R)``), which
is how the tests hold them. (The JAX package's step takes whatever a process
passes as the global batch, so its own ``shard_batches`` contract and its
step disagree across processes: ROADMAP Queue 3.) Replicas stay bit-equal:
every rank applies the same reduced gradients. At rdp > 1 the step refuses,
naming the ROADMAP item: rdp beside cp (item 5b), random draws inside the step
(dropout, router jitter: each rank would have to draw its rows' part of the
global mask at its row offset, item 6), fp16 and ``matmul_precision: fp8``
(the overflow flag and the amax would have to agree over the group, item 6)
and the health sentinel (its word would have to be the group's, item 6). A
collective that fails because a peer died (gloo's error at the socket's EOF,
or ``SMP_COLLECTIVE_TIMEOUT``) reaches the caller as ``SMPPeerLost`` naming
the peer whose bus link is down, which ``smp.supervisor.recover`` takes.

Data parallelism beside context parallelism (rdp > 1 and cp > 1). Every cp
rank of an rdp group is handed the same rows: the rdp coordinate's rows of
the per-process contract above (``shard_batches`` cuts by the row coordinate
and ignores cp). The step cuts the rank's sequence shard out of them, as at cp
alone, and the ring (or Ulysses) runs within each cp group. The loss weights,
the ``StepOutput`` means and the gradients go over the data group (every
rank: rdp x cp, ``topology.DATA_AXES``), whose size is the divisor; per-token
outputs are gathered along the sequence within the cp group, then along the
rows within the row group (``ROW_AXES``). The JAX package's single-process
step at ``context_parallel_degree`` 2 and rdp 2 is the oracle
(``tests/test_torch_dp_cp_step.py``).

Expert parallelism (ep > 1). The ep axis is a data axis: ep ranks are handed
other rows, as rdp ranks are (row coordinate ``r * ep + e`` in mesh order),
and each holds E/ep of every ``DistributedMoE``'s experts (``nn/moe.py``: the
routing is global over the data group, the tokens reach their experts by
all-to-alls over the ep group). The dense gradients are all-reduced over the
data group; the expert gradients over the ranks that hold the same experts
(``EXPERT_REPLICA_AXES``, rdp x cp) only; both are divided by ``microbatches x
data degree``. The MoE's folded load-balancing term (``model._aux_term``) is
each rank's part of the JAX package's global sum, so the step scales it by
the data degree (as a sum) where it scales the loss by the rank's share (as a
weighted mean). The refusals of rdp > 1 hold at ep > 1 too; so does
``smp.save_checkpoint`` (sharded state, ROADMAP item 9).

Observability, at the step's edges as in the JAX step engine: the phase
``step_<n>`` (``telemetry.set_phase``, which also drives the goodput ledger),
the flight recorder's step ``begin``/``end``, the ``SMP_PROFILE`` capture's
step hooks, ``smp_step_total``, ``smp_step_tokens_total``, the step-time
histograms, the goodput tick, the memory gauges and the
``SMP_WRITE_STEP_MEMORY_METRICS`` file, and ``state.timeline`` spans
(``SMP_TIMELINE_PATH``). Launches are asynchronous, so the step's wall time
is a lower bound; on the sampled steps (``profiling.should_sample_step``:
the first, then every 16th) the step synchronizes the device under the
``step/fetch`` region, and only those exact times feed the roofline
(``smp_mfu``, FLOPs from ``profiling.lm_step_flops``). The fused-kernel and
fp8 dispatch counters the JAX package ticks while it traces are replayed on
the first run of each step function and input shapes
(``model.replay_program_ticks``).

Resilience, as in the JAX step engine at world size 1:
- the health sentinel (``SMP_HEALTH_CHECK``, ``utils/health.py``): the step
  collects what the JAX step program tags (``params`` under ``full`` at the
  step's start, ``loss`` and ``outputs`` a microbatch, ``grads`` after the
  division), reduces them in one launch of the ``health_reduce`` kernel and
  submits the word to ``health.monitor`` with a bisector over the step's
  microbatch inputs, keys and dispatch-time parameters (the half casts the
  step made, or under fp32 a clone of the parameters, which the optimizer
  updates in place; held one step, while the sentinel is on). Under fp16 the
  gradients' finiteness comes from the same kernel's count, one readback;
- the OOM post-mortem: an out-of-memory error of the dispatch writes
  ``health.oom_postmortem``'s dump and reaches the caller unchanged;
- at the step edge, after the observability hooks and in the JAX package's
  order: ``chaos.on_step_edge`` (``SMP_CHAOS``),
  ``preemption.maybe_emergency_save`` (SIGTERM, ``SMP_PREEMPTION_FILE``;
  at world > 1 after ``preemption.agree_at_edge``, one flag all-reduce that
  stops every rank at the edge where any was preempted) and, when active,
  ``supervisor.on_step_edge`` (``SMP_SUPERVISOR``);
  ``chaos.on_step_dispatch`` runs inside ``step/dispatch``.

Tensor parallelism (tp > 1). The tp ranks of one data coordinate are
handed the same rows (``shard_batches`` cuts by the row coordinate, rdp x
ep, and ignores tp, as it ignores cp) and run the same microbatches: each
holds its shards of the ``smp.nn`` layers (``nn/transformer.py``), the tp
regions exchange inside the forward and backward, and every rank's outputs
and loss are the whole ones. The gradients are all-reduced over the data
group (``DATA_AXES``, which excludes tp) and divided as above; a shard's
gradient stays on its rank, a replicated parameter's is the same on every tp
rank. Under ``optimize: "memory"`` the layer stacks run their residual
stream sharded along T, so the replicated parameters inside them (the
layernorms and the row-parallel biases) are first summed over tp
(``model._stack_replicated``), as GSPMD's transpose sums them in the JAX
package. tp runs beside rdp. Every single-card training option runs at tp >
1 as it does in the JAX package:
  - ``tp_overlap: "ring"`` (``ops/collective_matmul.py``; the fused QKV then
    runs a ``matmul_bias`` launch a ring chunk);
  - dropout: every tp rank draws the keys a tp = 1 step draws, and a shard
    its part of the whole mask (``nn/utils.dropout``);
  - activation checkpointing (``parallel/memory.py``);
  - fp8: each slot's amax is the max over the tp group before
    ``quant.finalize`` rolls it, so every rank's scales are the global ones;
  - the sentinel and fp16's overflow flag: the health word is the tp group's
    (``HealthCollector.pack``: shards counted on every rank, replicated
    tensors on the first), so a shard that overflows makes every rank skip
    the step and move the scale.
At tp > 1 the step refuses tp beside cp or ep, and the model refuses
``DistributedMoE`` and the encoder-decoder, each naming ROADMAP item 7b.

Pipeline parallelism (pp > 1): ``_run_pipeline`` runs this rank's stage of
the pipelined step (``parallel/pipeline.py``, ``parallel/pipeline_1f1b.py``):
1F1B for a training step under ``pipeline: "interleaved"`` at
``virtual_pipeline_degree`` 1, fill-drain for ``"simple"`` and for a step
without ``model.backward``. What stays refused at pp > 1 raises naming
ROADMAP item 8 (``parallel/pipeline.check_supported``).

Not ported yet, each raising ``NotImplementedError`` when asked for:
ZeRO-3 (``sharded_params``), shape buckets (``SMP_SHAPE_BUCKETS``), the
executable cache (``SMP_EXEC_CACHE``) and the compiled-program audit
(``SMP_HLO_AUDIT``).
"""

import contextlib
import functools
import inspect
import os
import time

import torch

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.split import (
    DeferredSplit,
    NonSplit,
    StepOutput,
    TensorSplitter,
    microbatch_slice,
    tree_leaves,
    tree_map,
)
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS, DATA_AXES, EXPERT_REPLICA_AXES, ROW_AXES, TP_AXIS
from smdistributed_modelparallel_tpu_torch.model import DistributedModel, replay_program_ticks
from smdistributed_modelparallel_tpu_torch.nn.utils import collect_program_ticks
from smdistributed_modelparallel_tpu_torch.ops.collective_matmul import fused_qkv_effective, tp_overlap_mode
from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.resilience.preemption import preemption
from smdistributed_modelparallel_tpu_torch.resilience.supervisor import supervisor
from smdistributed_modelparallel_tpu_torch.utils import health, profiling, random
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError, StepUsageError
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.metrics import record_device_memory_telemetry
from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_step_time, telemetry

logger = get_logger()


def _env_on(name):
    return os.environ.get(name, "").strip().lower() in ("on", "1", "true")


def _env_set(name):
    return bool(os.environ.get(name, "").strip())


# (environment variable, what it arms in the JAX package, whether it asks).
_LEFT_OUT_ENV = (
    ("SMP_SHAPE_BUCKETS", "shape buckets", _env_set),
    ("SMP_EXEC_CACHE", "the executable cache", _env_on),
    ("SMP_HLO_AUDIT", "the compiled-program audit", _env_on),
)


def _not_ported(what):
    return NotImplementedError(f"@smp.step: {what} is not ported to PyTorch yet (a later slice).")


def _check_supported(cfg):
    if cfg.pipeline_parallel_degree > 1:
        from smdistributed_modelparallel_tpu_torch.parallel.pipeline import check_supported

        check_supported(cfg)
    topo = state.topology
    if cfg.tensor_parallel_degree > 1 and topo.cp_size * topo.ep_size > 1:
        raise NotImplementedError(
            "@smp.step: tp beside context or expert parallelism at tensor_parallel_degree > 1 is not ported to "
            "PyTorch yet (ROADMAP item 7b)."
        )
    if topo.rdp_size * topo.ep_size > 1:
        for asks, what in ((cfg.fp16, "fp16 (the loss scaler's overflow flag)"),
                           (quant.matmul_precision_mode(cfg) == "fp8", "matmul_precision: fp8 (the amax)"),
                           (health.mode() != "off", "SMP_HEALTH_CHECK (the sentinel's word)")):
            if asks:
                raise NotImplementedError(
                    f"@smp.step: {what} under data parallelism (rdp = {topo.rdp_size}, expert_parallel_degree = "
                    f"{topo.ep_size}) would have to agree over the data group, which is not ported to PyTorch yet "
                    "(ROADMAP Queue 1 item 6)."
                )
    if cfg.context_parallel_degree > 1:
        if cfg.fp16:
            raise NotImplementedError(
                "@smp.step: fp16 under context parallelism (the loss scaler's overflow flag would have to "
                "agree across the cp ranks) is not ported to PyTorch yet (a later context-parallel slice)."
            )
        if quant.matmul_precision_mode(cfg) == "fp8":
            raise NotImplementedError(
                "@smp.step: matmul_precision: fp8 under context parallelism (amax would need a cross-rank "
                "max) is not ported to PyTorch yet (a later context-parallel slice)."
            )
    if cfg.zero3_enabled:
        raise _not_ported("sharded_params: zero3 (ZeRO-3)")
    for env, what, asks in _LEFT_OUT_ENV:
        if asks(env):
            raise _not_ported(f"{what} ({env})")


def _acc_dtype(dtype, cfg):
    if dtype.is_floating_point and cfg._fp32_grad_accumulation:
        return torch.float32
    return dtype


def _positional_names(fn, n):
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return [None] * n
    names = [p.name for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    names += [None] * (n - len(names))
    return names[:n]


def _shard_sequence(tree, index, n):
    """The rank's contiguous shard of the dimension after the split axis of
    every split leaf that has one (a stacked leaf carries the [num_mb] axis
    in front)."""

    def cut(leaf, axis, stacked):
        dim = axis + 1 + int(stacked)
        if not isinstance(leaf, torch.Tensor) or leaf.dim() <= dim:
            return leaf
        if leaf.shape[dim] % n:
            raise SMPValidationError(
                f"Sequence length {leaf.shape[dim]} (dimension {dim} of a split input) must be divisible "
                f"by context_parallel_degree {n}."
            )
        step = leaf.shape[dim] // n
        return torch.narrow(leaf, dim, index * step, step)

    return tree_map(lambda x: DeferredSplit(cut(x.value, x.axis, x.stacked), x.axis, x.num_mb, x.stacked)
                    if isinstance(x, DeferredSplit) else x,
                    tree, is_leaf=lambda x: isinstance(x, (NonSplit, DeferredSplit)))


class _LossLeaf:
    """An output leaf that is the loss ``model.backward`` marked."""

    def __init__(self, value):
        self.value = value


def _mean(group, x):
    return group.all_reduce(x.float()).div_(group.size).to(x.dtype)


def _combine(stacked, group, weights, cp, rows):
    """The data group's view of the per-rank [num_mb, ...] outputs: the
    marked loss weighted by this rank's ``weights`` [num_mb] and summed over
    ``group``, other values of at most one dimension per microbatch averaged
    over it, and the rest per-row: per-token values (three or more
    dimensions) gathered along the sequence over the ``cp`` group, per-row
    ones of two averaged over it, then all gathered along the rows over the
    ``rows`` group."""

    def combine(x):
        loss = isinstance(x, _LossLeaf)
        x = x.value if loss else x
        if group is None or not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        if loss and x.dim() <= 1 + (rows is None):
            w = weights.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
            return group.all_reduce(x.float() * w).to(x.dtype)
        if x.dim() <= 1:
            return _mean(group, x)
        if cp is not None:
            x = cp.all_gather(x, dim=2) if x.dim() > 2 else _mean(cp, x)
        return rows.all_gather(x, dim=1) if rows is not None else x

    return tree_map(combine, stacked, is_leaf=lambda x: isinstance(x, _LossLeaf))


def _typed_peer_loss(fn):
    """Run ``fn`` (a collective); a failure caused by a dead peer raises
    ``SMPPeerLost`` instead."""
    try:
        return fn()
    except RuntimeError as e:
        lost = _peer_lost(e)
        if lost is not None:
            raise lost from e
        raise


def _peer_lost(error):
    """``SMPPeerLost`` for a collective that failed because a peer died:
    the first peer whose host-bus link is marked down within a few seconds
    (the bus sees the dead process's sockets close), or the supervisor's
    classification; None when no peer is down (the error is the caller's)."""
    from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPPeerLost

    bus = state.bus
    if bus is None or bus.world <= 1:
        return None
    deadline = time.monotonic() + 5.0
    while True:
        failures = supervisor.failures()
        down = [p for p in range(bus.world) if p != bus.rank and bus.peer_down(p)] or sorted(failures)
        if down:
            return SMPPeerLost(down[0], f"@smp.step: a collective failed and process {down[0]} is unreachable "
                                        f"({type(error).__name__}: {error}); smp.supervisor.recover() re-forms the "
                                        "world from the survivors.")
        if time.monotonic() > deadline:
            return None
        time.sleep(0.1)


@contextlib.contextmanager
def _cp_sharded_off():
    """Clear ``state.cp_sharded`` and ``state.rdp_sharded`` when the
    microbatch loop ends."""
    try:
        yield
    finally:
        state.cp_sharded = state.rdp_sharded = False


def _loss_weight(group, num_tokens):
    """This rank's weight of a microbatch's loss in the group's: its share
    of the tokens the group's loss averages over, equal shares when the
    loss did not give its count."""
    if group is None:
        return 1.0
    if num_tokens is None:
        return 1.0 / group.size
    mine = torch.as_tensor(num_tokens, dtype=torch.float64).reshape(1).cpu()
    total = float(group.all_reduce(mine.clone())[0])
    if total <= 0:
        raise SMPValidationError("model.backward(num_tokens=...) counts no token on any rank of the group.")
    return float(mine[0]) / total


def _stack_outputs(outs):
    """Per-microbatch output trees -> one tree of [num_mb, ...] leaves."""
    first = outs[0]
    if isinstance(first, _LossLeaf):
        return _LossLeaf(_stack_outputs([o.value for o in outs]))
    if isinstance(first, dict):
        return {k: _stack_outputs([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_outputs(list(col)) for col in zip(*outs))
    if first is None:
        return None
    return torch.stack([torch.as_tensor(o) for o in outs])


def _split_leaves(stacked):
    """The ``DeferredSplit`` and ``NonSplit`` leaves of a stacked tree."""
    leaves = []
    tree_map(leaves.append, stacked, is_leaf=lambda x: isinstance(x, (NonSplit, DeferredSplit)))
    return [x for x in leaves if isinstance(x, (NonSplit, DeferredSplit))]


def _count_tokens(stacked):
    """``(tokens, (batch, seq))`` of the step's batch for the throughput
    counter and the FLOP count: the JAX step's ``_count_tokens``, the
    batch x sequence dims of the FIRST split input with at least two
    dimensions (a pre-stacked input's [num_mb, mb] count as its batch);
    ``(0, None)`` when there is none."""
    for leaf in _split_leaves(stacked):
        shape = tuple(getattr(leaf.value, "shape", ()))
        if not isinstance(leaf, DeferredSplit) or len(shape) < 2:
            continue
        if leaf.stacked:
            if len(shape) < 3:
                return shape[0] * shape[1], None
            return shape[0] * shape[1] * shape[2], (shape[0] * shape[1], shape[2])
        return shape[0] * shape[1], (shape[0], shape[1])
    return 0, None


def _program_key(stacked, model):
    """What the JAX package keys its compiled step program on, as far as the
    port can see it: the shapes and dtypes of the tensor inputs, the model's
    train/eval mode and the overlapped-tp knobs as the JAX step canonicalizes
    them (``tp_overlap_mode``, ``fused_qkv_effective``)."""
    return tuple((tuple(x.value.shape), x.value.dtype) for x in _split_leaves(stacked)
                 if isinstance(x.value, torch.Tensor)), model.training, tp_overlap_mode(), fused_qkv_effective()


def _synchronize(device):
    """Wait for ``device``'s queued work (a CUDA device; the CPU runs
    synchronously)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _jax_leaves(model, tensors):
    """``tensors`` ({parameter name: tensor}) as the sentinel's leaves: one
    ``health.Leaf`` a JAX leaf (a layer stack's per-layer tensors of one
    flax parameter together), in the JAX package's sorted key order."""
    groups = model._health_leaf_groups
    if groups is None or set(tensors) - set(groups[1]):
        groups = model._health_leaf_groups = health.jax_leaf_groups(model, list(tensors))
    specs = model._tp_specs
    return [health.Leaf((tensors[n] for n in names if n in tensors), sharded=any(n in specs for n in names))
            for names in groups[0]]


class StepFunction:
    def __init__(self, fn, non_split_inputs=None, input_split_axes=None):
        self.fn = fn
        self.non_split_inputs = non_split_inputs
        self.input_split_axes = input_split_axes
        self._has_backward = None  # learned from the first microbatch run
        self._programs = {}  # _program_key -> the step's counted FLOPs
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if state.cfg is None:
            raise StepUsageError("Call smp.init(config) before invoking an @smp.step function.")
        cfg = state.cfg
        _check_supported(cfg)
        model = next((a for a in (*args, *kwargs.values()) if isinstance(a, DistributedModel)), state.model)
        if model is None:
            raise StepUsageError("Create smp.DistributedModel before invoking an @smp.step function.")
        splitter = TensorSplitter(cfg.microbatches, self.non_split_inputs, self.input_split_axes)
        stacked = splitter.stack_microbatches(args, kwargs, _positional_names(self.fn, len(args)))
        n = state.step_count
        key = _program_key(stacked, model)
        new_program = key not in self._programs
        tokens, batch_seq = _count_tokens(stacked)
        if tokens:
            telemetry.counter("smp_step_tokens_total", "input tokens consumed by step invocations").inc(tokens)
        tl = state.timeline
        timeline_on = tl is not None and tl.enabled
        telemetry.set_phase(f"step_{n}")
        flight_recorder.record_step("begin", n)
        # On-demand profiler capture (SMP_PROFILE=steps=N:M / SIGUSR2):
        # starts exactly at this step's begin edge when armed; a single
        # attribute test otherwise.
        profiling.capture.on_step_begin(n)
        t_step = time.perf_counter()
        if timeline_on:
            tl.start_step(n)
        exact_time = profiling.should_sample_step(n)
        with (collect_program_ticks() if new_program else contextlib.nullcontext()) as notes, \
                (tl.span(f"step_{n}") if timeline_on else contextlib.nullcontext()):
            try:
                with profiling.region("step/dispatch"):
                    # Chaos seam: `wedge@step=N:ms=M` hangs here, inside the
                    # dispatch region, before the microbatches run.
                    chaos.on_step_dispatch(n)
                    out = self._run(model, cfg, *stacked)
            except RuntimeError as e:  # torch.OutOfMemoryError among them
                # Out of memory: dump the live tensors, the allocator's
                # statistics and the memory config before the error
                # reaches the caller (utils/health.py).
                health.maybe_oom_postmortem("step", None, e)
                # A collective with a dead peer: typed, for the supervisor.
                lost = _peer_lost(e) if state.groups and not isinstance(e, torch.OutOfMemoryError) else None
                if lost is not None:
                    raise lost from e
                raise
            if exact_time:
                # Roofline sample: wait for the device so the measured time
                # covers the step's kernels. Without it the launch time is a
                # lower bound and smp_mfu would overreport (possibly > 1).
                with profiling.region("step/fetch"):
                    _synchronize(model.device)
        if timeline_on:
            tl.end_step(n)
            tl.flush()
        # Wall time: exact on a sampled step, otherwise a lower bound
        # (launches return before the device finishes).
        t_step = time.perf_counter() - t_step
        telemetry.histogram("smp_step_dispatch_seconds", "host wall time per step dispatch").observe(t_step)
        record_step_time(t_step)
        if new_program:
            self._programs[key] = profiling.lm_step_flops(model.module, *batch_seq, backward=self._has_backward) \
                if batch_seq else None
            # The JAX package traces a new step program once; on the model's
            # first use also its lazy init (flax's init and an eager apply),
            # where the fused-kernel gates run but no fp8 seam does.
            first = model._first_program()
            replay_program_ticks(notes, lambda kind, phase: 3 if first and kind == "fused" else 1)
        # Goodput ledger tick (publish + sentinel window at most once per
        # tick interval): one attribute test while disarmed.
        goodput.on_step_edge(n)
        profiling.capture.on_step_end(n)
        if exact_time:
            profiling.record_step_roofline("step", t_step, self._programs[key])
        flight_recorder.record_step("end", n)
        telemetry.counter("smp_step_total", "step invocations").inc()
        if state.memory_metrics is not None:
            state.memory_metrics.record_step(n)
        record_device_memory_telemetry()
        state.step_count += 1
        # Step edge, in the JAX package's order: chaos faults land here, a
        # pending preemption (SIGTERM, sentinel file) becomes the emergency
        # checkpoint, and the supervisor's hook is one attribute test while
        # SMP_SUPERVISOR is off.
        chaos.on_step_edge(state.step_count)
        if state.world_size > 1:
            _typed_peer_loss(preemption.agree_at_edge)
        preemption.maybe_emergency_save()
        if supervisor.active:
            supervisor.on_step_edge()
        return out

    def _run(self, model, cfg, stacked_args, stacked_kwargs):
        """The microbatch loop: forward, backward and gradient accumulation
        of every microbatch; returns the step's ``StepOutput``."""
        if cfg.pipeline_parallel_degree > 1:
            return self._run_pipeline(model, cfg, stacked_args, stacked_kwargs)
        num_mb = cfg.microbatches
        group = state.group(DATA_AXES)  # every rank that holds tokens of the microbatch
        cp, rows, tp = state.group(CP_AXIS), state.group(ROW_AXES), state.group(TP_AXIS)
        if cp is not None:
            stacked_args, stacked_kwargs = _shard_sequence((stacked_args, stacked_kwargs), cp.index, cp.size)
        # Forgot-optimizer.step() detector: unconsumed grads with the
        # parameters untouched since the previous training step.
        stale = model._grads is not None and model._params_at_step == model._param_version

        params = dict(model.module.named_parameters())
        hmode = health.mode()
        bound = _bind_params(params, cfg.half_dtype)
        loss_scale = state.loss_scaler.loss_scale if state.loss_scaler is not None else 1.0
        rng = state.step_rng if state.step_rng is not None else state.rng_manager.next_key("step")
        use_rng, next_rng = random.split(rng)
        mb_keys = random.split(use_rng, num_mb)
        names = [n for n, t in bound.items() if t.requires_grad]
        acc = None
        outs = []
        losses = []  # the differentiated loss of each microbatch (the sentinel's "loss")
        weights = []  # this rank's share of each microbatch's loss over the data group
        qs = quant.ensure_state(model.device) if quant.matmul_precision_mode(cfg) == "fp8" else None
        state.cp_sharded = cp is not None
        state.rdp_sharded = rows is not None
        model._seq_parallel_ran = False
        with health.collecting(hmode) as hc:
            with quant.step_trace(qs), _cp_sharded_off():
                if hc is not None and hmode == "full":
                    hc.add_tree("params", _jax_leaves(model, {n: p.detach() for n, p in params.items()}))
                for mb in range(num_mb):
                    mb_args, mb_kwargs = tree_map(
                        lambda x: x.to(model.device) if isinstance(x, torch.Tensor) else x,
                        (microbatch_slice(stacked_args, mb), microbatch_slice(stacked_kwargs, mb)),
                    )
                    model._begin_microbatch(bound, {s: random.fold_in(mb_keys[mb], h)
                                                    for h, s in enumerate(model.rng_streams)})
                    try:
                        with torch.enable_grad() if self._has_backward is not False else torch.no_grad():
                            out = self.fn(*mb_args, **mb_kwargs)
                    finally:
                        loss, num_tokens, differentiated = model._end_microbatch()
                    weights.append(_loss_weight(group, num_tokens))
                    if self._has_backward is None:
                        self._has_backward = loss is not None
                    if self._has_backward:
                        if loss is None:
                            raise StepUsageError("model.backward(loss) was not called in the step function.")
                        if hc is not None:
                            # The JAX step's per-microbatch loss: the scaled
                            # loss it differentiates, over the scale.
                            d = differentiated.detach()
                            losses.append(d * loss_scale / loss_scale if loss_scale != 1.0 else d)
                        # Under cp or rdp the loss is scaled by this rank's share
                        # before the backward (under cp the ring carries its
                        # cotangents to the other ranks' k/v, whose gradients
                        # land there); the group's sum over its size is then
                        # the gradient of the group's loss.
                        scale = loss_scale * weights[-1] * (group.size if group is not None else 1)
                        # The MoE load-balancing losses of this microbatch enter
                        # its gradient (differentiated), not the returned loss.
                        # Over several data ranks each rank's is its part of a
                        # global sum: scaled by the group's size, not its share.
                        if group is not None and model._aux_term is not None:
                            objective = loss * scale + model._aux_term * (loss_scale * group.size)
                        else:
                            objective = differentiated * scale if scale != 1.0 else differentiated
                        grads = torch.autograd.grad(objective, [bound[n] for n in names], allow_unused=True)
                        if acc is None:
                            acc = {n: torch.zeros(params[n].shape, dtype=_acc_dtype(params[n].dtype, cfg),
                                                  device=params[n].device) for n in names}
                        for n, g in zip(names, grads):
                            if g is not None:
                                acc[n].add_(g)
                    elif loss is not None:
                        raise StepUsageError(
                            "model.backward() called in a step function whose first run did not call it."
                        )
                    outs.append(tree_map(
                        lambda x: (_LossLeaf(x.detach()) if x is loss else x.detach()) if isinstance(x, torch.Tensor)
                        else x, out))
                if qs is not None:
                    qs.absorb(quant.finalize(qs, tp))
            stacked = _combine(_stack_outputs(outs), group, torch.tensor(weights), cp, rows)
            if hc is not None:
                if losses:
                    hc.add_stacked("loss", health.Leaf(losses), num_mb)
                hc.add_stacked("outputs", tree_map(lambda x: x.value if isinstance(x, _LossLeaf) else x, stacked,
                                                   is_leaf=lambda x: isinstance(x, _LossLeaf)), num_mb)
            step_grads = self._finish_grads(model, cfg, group, params, names, acc, num_mb, loss_scale, stale) \
                if self._has_backward else None
            word = None
            if hc is not None:
                if step_grads is not None:
                    hc.add_tree("grads", _jax_leaves(model, step_grads))
                word, schema = hc.pack(tp)
        state.step_rng = next_rng
        if step_grads is not None and cfg.fp16:
            # The overflow flag from the sentinel kernel's count: one launch
            # (shared with the sentinel when it is on) and one readback.
            if word is None or "grads" not in schema:
                overflow = health.HealthCollector("cheap")
                overflow.add_tree("grads", _jax_leaves(model, step_grads))
                word, schema = overflow.pack(tp)
            model._grads_finite = word[schema.index("grads"), 0].item() == 0.0
        if hc is not None and word is not None:
            health.monitor.submit(state.step_count, word, schema, hmode,
                                  self._bisector(model, cfg, bound, params, stacked_args, stacked_kwargs, rng)
                                  if group is None else None)
        return StepOutput(stacked)

    def _run_pipeline(self, model, cfg, stacked_args, stacked_kwargs):
        """pp > 1: this rank's stage of the pipelined step
        (``parallel/pipeline.py``). The step function runs once a microbatch
        up to its model call, whose inputs are captured; on the first run of
        this function once more with the call answered by the head of the
        embedding (``StageExecutor.probe``), which tells whether it calls
        ``model.backward``; then the schedule: 1F1B (``pipeline:
        "interleaved"``, ``parallel/pipeline_1f1b.py``) for a training step,
        fill-drain (``"simple"``, and every step without a backward). The
        last stage runs the function forced to its head output and seeds each
        loss with 1 / microbatches. Afterwards the replicated
        parameters' gradients are summed over the pp group (``wte`` feeds the
        embedding on the first stage and the tied head on the last), and the
        last stage's outputs are broadcast, so that every rank returns the
        same ``StepOutput``."""
        from smdistributed_modelparallel_tpu_torch.backend.topology import PP_AXIS
        from smdistributed_modelparallel_tpu_torch.model import CaptureStop
        from smdistributed_modelparallel_tpu_torch.parallel import pipeline as pl
        from smdistributed_modelparallel_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b

        num_mb = cfg.microbatches
        stale = model._grads is not None and model._params_at_step == model._param_version
        params = dict(model.module.named_parameters())
        bound = _bind_params(params, cfg.half_dtype)
        rng = state.step_rng if state.step_rng is not None else state.rng_manager.next_key("step")
        use_rng, next_rng = random.split(rng)
        mb_keys = random.split(use_rng, num_mb)
        mbs = [tree_map(lambda x: x.to(model.device) if isinstance(x, torch.Tensor) else x,
                        (microbatch_slice(stacked_args, m), microbatch_slice(stacked_kwargs, m)))
               for m in range(num_mb)]
        rngs = [{s: random.fold_in(mb_keys[m], h) for h, s in enumerate(model.rng_streams)} for m in range(num_mb)]

        def call(m, mode, value=None):
            """The step function of microbatch m with its model call in
            ``mode``: (its output, the marked loss, the loss to differentiate)."""
            args, kwargs = mbs[m]
            model._begin_microbatch(bound, rngs[m])
            model._call_mode, model._calls, model._captured = (mode, value), 0, None
            try:
                out = self.fn(*args, **kwargs)
            except CaptureStop:
                out = None
            finally:
                model._call_mode = None
                loss, _, differentiated = model._end_microbatch()
            if model._calls == 0:
                raise StepUsageError("pipeline_parallel_degree > 1 requires exactly one model(...) call per step "
                                     "function (got 0).")
            return out, loss, differentiated

        def capture(m):
            with torch.no_grad():
                call(m, "capture")
            return model._captured

        inputs = [capture(m) for m in range(num_mb)]

        def loss_fn(m, head):
            out, loss, differentiated = call(m, "force", head)
            if ex.backward and loss is None:
                raise StepUsageError("model.backward(loss) was not called in the step function.")
            if not ex.backward and loss is not None:
                raise StepUsageError("model.backward() called in a step function whose first run did not call it.")
            return differentiated, tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, out)

        # The seed is loss_scale / microbatches; the loss scale is 1 (fp16 is
        # refused at pp > 1, ROADMAP item 8).
        ex = pl.StageExecutor(model, bound, inputs, loss_fn, self._has_backward, 1.0 / num_mb)
        if self._has_backward is None:
            self._has_backward = ex.backward = ex.probe(lambda head: call(0, "probe", head)[1] is not None)
        if ex.backward and cfg.pipeline != "simple":
            error = pipeline_1f1b(ex)
        else:
            error = pl.pipeline_forward(ex)
        stacked = meta = None
        if ex.last and error is None:
            try:
                stacked = _stack_outputs([ex.outs[m] for m in range(num_mb)])
                meta = tree_map(lambda x: _Meta(x) if isinstance(x, torch.Tensor) else x, stacked)
            except Exception as e:  # noqa: BLE001 - every stage raises it in finish()
                error = e
        meta = ex.finish(error, meta)
        group = state.group(PP_AXIS)
        if not ex.last:
            stacked = tree_map(lambda x: x.empty(model.device) if isinstance(x, _Meta) else x, meta)
        leaves = [x for x in tree_leaves(stacked) if isinstance(x, torch.Tensor)]
        if leaves:
            group.flat_(functools.partial(group.broadcast, src=group.size - 1), leaves)
        model._pp_comm_seconds = ex.comm_s
        model._pp_transfers = ex.transfers
        state.step_rng = next_rng
        if ex.backward:
            _note_stale(model, stale)
            acc = ex.acc
            group.flat_(group.all_reduce, [acc[n] for n in ex.names if n not in model._pp_layer_params])
            model._grads = {n: acc[n].to(params[n].dtype) for n in ex.names}
            model._grads_finite = None
        return StepOutput(stacked)

    def _bisector(self, model, cfg, bound, params, stacked_args, stacked_kwargs, rng):
        """The trip bisector of this step: its microbatch inputs, keys and
        dispatch-time parameters (the half casts it made; under fp32 ``bound``
        aliases the parameters the optimizer updates in place, so a clone)."""
        if cfg.half_dtype is None:
            bound = {n: t.detach().clone() for n, t in bound.items()}
        else:
            bound = {n: t.detach() for n, t in bound.items()}

        def mb_args(mb):
            return tree_map(lambda x: x.to(model.device) if isinstance(x, torch.Tensor) else x,
                            (microbatch_slice(stacked_args, mb), microbatch_slice(stacked_kwargs, mb)))

        return health.make_bisector(model, self.fn, mb_args, cfg.microbatches, rng, self._has_backward,
                                    step_params=bound)

    def _finish_grads(self, model, cfg, group, params, names, acc, num_mb, loss_scale, stale):
        """The step's gradients: the microbatch sum over ``num_mb *
        loss_scale`` (and the data group: one flat all-reduce of the
        accumulators, an ep rank's experts' over the ranks that hold the
        same experts), in the parameters' dtypes."""
        _note_stale(model, stale)
        divisor = float(num_mb * loss_scale)
        tp = state.group(TP_AXIS)
        if tp is not None and model._seq_parallel_ran:
            # Sequence parallelism: each tp rank's replicated layernorms and
            # row-parallel biases saw its T shard only.
            tp.flat_(tp.all_reduce, [acc[n] for n in names if n in model._stack_replicated])
        if group is not None:
            experts = model._expert_params
            group.flat_(group.all_reduce, [acc[n] for n in names if n not in experts])
            replicas = state.group(EXPERT_REPLICA_AXES)
            if replicas is not None:
                replicas.flat_(replicas.all_reduce, [acc[n] for n in names if n in experts])
            divisor *= group.size
        # In place: the accumulators become the gradients, so the step's end
        # holds no second parameter-sized copy (GPT-2 1.5B: 5.8 GiB).
        model._grads = {n: acc[n].div_(divisor).to(params[n].dtype) for n in names}
        model._grads_finite = None
        return model._grads


def _note_stale(model, stale):
    """Count a training step whose gradients replace ones no
    ``optimizer.step()`` consumed; warn at the third."""
    if stale:
        model._dropped_updates += 1
        if model._dropped_updates == 3:
            logger.warning(
                "3 training steps ran without optimizer.step(): "
                "parameter updates are computed and then "
                "discarded, so the model is NOT learning. Call "
                "optimizer.step() after each step."
            )
    model._params_at_step = model._param_version


def _bind_params(params, half):
    """The step's compute parameters: each floating master parameter cast
    to ``half`` (when set), detached and requiring grad."""
    bound = {}
    for name, p in params.items():
        t = p.detach()
        if half is not None and t.is_floating_point():
            t = t.to(half)
        bound[name] = t.requires_grad_() if t.is_floating_point() else t
    return bound


class _Meta:
    """A tensor's shape and dtype, pickled to the other stages."""

    def __init__(self, x):
        self.shape, self.dtype = tuple(x.shape), x.dtype

    def empty(self, device):
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def step(fn=None, *, non_split_inputs=None, input_split_axes=None):
    """Decorator: ``@smp.step`` or ``@smp.step(non_split_inputs=[...])``."""
    if fn is not None:
        return StepFunction(fn)

    def wrap(f):
        return StepFunction(f, non_split_inputs, input_split_axes)

    return wrap
