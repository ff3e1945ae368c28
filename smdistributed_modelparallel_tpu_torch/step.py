"""``@smp.step``: the training-step engine of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/step.py`` (``StepFunction``)
for one device at pipeline degree 1. The JAX package traces the whole step
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
Under cp the step refuses data parallelism beside cp (rdp > 1, the
data-parallel slice), fp16 (the loss scaler's overflow flag would have to
agree across ranks) and ``matmul_precision: fp8`` (amax would need a
cross-rank max).

Not ported yet, each raising ``NotImplementedError`` when asked for:
pipeline parallelism, tensor parallelism, data parallelism (rdp > 1),
expert parallelism, ZeRO-3 (``sharded_params``), shape
buckets (``SMP_SHAPE_BUCKETS``), the health sentinel (``SMP_HEALTH_CHECK``),
the executable cache (``SMP_EXEC_CACHE``), the compiled-program audit
(``SMP_HLO_AUDIT``), and the telemetry, chaos, preemption and supervisor
hooks of the step edge.
"""

import contextlib
import functools
import inspect
import os

import torch

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.split import (
    DeferredSplit,
    NonSplit,
    StepOutput,
    TensorSplitter,
    microbatch_slice,
    tree_map,
)
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
from smdistributed_modelparallel_tpu_torch.model import DistributedModel
from smdistributed_modelparallel_tpu_torch.utils import random
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError, StepUsageError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


def _env_on(name):
    return os.environ.get(name, "").strip().lower() in ("on", "1", "true")


def _env_set(name):
    return bool(os.environ.get(name, "").strip())


def _health_on(name):
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "off", "no", "none")


# (environment variable, what it arms in the JAX package, whether it asks).
_LEFT_OUT_ENV = (
    ("SMP_SHAPE_BUCKETS", "shape buckets", _env_set),
    ("SMP_HEALTH_CHECK", "the health sentinel", _health_on),
    ("SMP_EXEC_CACHE", "the executable cache", _env_on),
    ("SMP_HLO_AUDIT", "the compiled-program audit", _env_on),
    ("SMP_TELEMETRY_PATH", "the telemetry dump", _env_set),
    ("SMP_CHAOS", "the chaos harness", _env_set),
    ("SMP_PREEMPTION_FILE", "preemption handling", _env_set),
    ("SMP_SUPERVISOR", "the failure-recovery supervisor", _env_on),
)


def _not_ported(what):
    return NotImplementedError(f"@smp.step: {what} is not ported to PyTorch yet (a later slice).")


def _check_supported(cfg):
    if cfg.pipeline_parallel_degree > 1:
        raise _not_ported("pipeline_parallel_degree > 1")
    if cfg.tensor_parallel_degree > 1:
        raise _not_ported("tensor_parallel_degree > 1")
    if state.topology.rdp_size > 1:
        raise NotImplementedError(
            f"@smp.step: data parallelism (rdp = {state.topology.rdp_size} replicas) is not ported to "
            "PyTorch yet (the data-parallel slice)."
        )
    if cfg.expert_parallel_degree > 1:
        raise NotImplementedError(
            "@smp.step: expert_parallel_degree > 1 (experts sharded over the ep axis) is not ported to PyTorch "
            "yet (the data-parallel slice)."
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


def _combine_over_cp(stacked, group, weights):
    """The cp group's view of the per-rank [num_mb, ...] outputs: the marked
    loss weighted by this rank's ``weights`` [num_mb] and summed, other
    values of at most one dimension per microbatch averaged, per-token
    values gathered along the sequence."""

    def combine(x):
        loss = isinstance(x, _LossLeaf)
        x = x.value if loss else x
        if group is None or not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        if x.dim() >= 3:
            return group.all_gather(x, dim=2)
        if loss:
            w = weights.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
            return group.all_reduce(x.float() * w).to(x.dtype)
        return group.all_reduce(x.float()).div_(group.size).to(x.dtype)

    return tree_map(combine, stacked, is_leaf=lambda x: isinstance(x, _LossLeaf))


@contextlib.contextmanager
def _cp_sharded_off():
    """Clear ``state.cp_sharded`` when the microbatch loop ends."""
    try:
        yield
    finally:
        state.cp_sharded = False


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
        raise SMPValidationError("model.backward(num_tokens=...) counts no token on any cp rank.")
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


class StepFunction:
    def __init__(self, fn, non_split_inputs=None, input_split_axes=None):
        self.fn = fn
        self.non_split_inputs = non_split_inputs
        self.input_split_axes = input_split_axes
        self._has_backward = None  # learned from the first microbatch run
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if state.cfg is None:
            raise StepUsageError("Call smp.init(config) before invoking an @smp.step function.")
        cfg = state.cfg
        _check_supported(cfg)
        model = next((a for a in (*args, *kwargs.values()) if isinstance(a, DistributedModel)), state.model)
        if model is None:
            raise StepUsageError("Create smp.DistributedModel before invoking an @smp.step function.")
        num_mb = cfg.microbatches
        splitter = TensorSplitter(num_mb, self.non_split_inputs, self.input_split_axes)
        stacked_args, stacked_kwargs = splitter.stack_microbatches(
            args, kwargs, _positional_names(self.fn, len(args))
        )
        group = state.group(CP_AXIS)
        if group is not None:
            stacked_args, stacked_kwargs = _shard_sequence((stacked_args, stacked_kwargs), group.index, group.size)
        # Forgot-optimizer.step() detector: unconsumed grads with the
        # parameters untouched since the previous training step.
        stale = model._grads is not None and model._params_at_step == model._param_version

        params = dict(model.module.named_parameters())
        half = cfg.half_dtype
        bound = {}
        for name, p in params.items():
            t = p.detach()
            if half is not None and t.is_floating_point():
                t = t.to(half)
            bound[name] = t.requires_grad_() if t.is_floating_point() else t
        loss_scale = state.loss_scaler.loss_scale if state.loss_scaler is not None else 1.0
        rng = state.step_rng if state.step_rng is not None else state.rng_manager.next_key("step")
        use_rng, next_rng = random.split(rng)
        mb_keys = random.split(use_rng, num_mb)
        names = [n for n, t in bound.items() if t.requires_grad]
        acc = None
        outs = []
        weights = []  # this rank's share of each microbatch's loss over the cp group
        qs = quant.ensure_state(model.device) if quant.matmul_precision_mode(cfg) == "fp8" else None
        state.cp_sharded = group is not None
        with quant.step_trace(qs), _cp_sharded_off():
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
                    # Under cp the loss is scaled by this rank's share before
                    # the backward: the ring carries its cotangents to the
                    # other ranks' k/v, whose gradients land there.
                    scale = loss_scale * weights[-1] * (group.size if group is not None else 1)
                    # The MoE load-balancing losses of this microbatch enter
                    # its gradient (differentiated), not the returned loss.
                    grads = torch.autograd.grad(
                        differentiated * scale if scale != 1.0 else differentiated,
                        [bound[n] for n in names], allow_unused=True,
                    )
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
                qs.absorb(quant.finalize(qs))
        state.step_rng = next_rng

        if self._has_backward:
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
            divisor = float(num_mb * loss_scale)
            if group is not None:
                group.flat_(group.all_reduce, [acc[n] for n in names])
                divisor *= group.size
            # In place: the accumulators become the gradients, so the step's end
            # holds no second parameter-sized copy (GPT-2 1.5B: 5.8 GiB).
            model._grads = {n: acc[n].div_(divisor).to(params[n].dtype) for n in names}
            model._grads_finite = (
                all(bool(torch.isfinite(g).all()) for g in model._grads.values())
                if cfg.fp16 else None
            )
        out = StepOutput(_combine_over_cp(_stack_outputs(outs), group, torch.tensor(weights)))
        state.step_count += 1
        return out


def step(fn=None, *, non_split_inputs=None, input_split_axes=None):
    """Decorator: ``@smp.step`` or ``@smp.step(non_split_inputs=[...])``."""
    if fn is not None:
        return StepFunction(fn)

    def wrap(f):
        return StepFunction(f, non_split_inputs, input_split_axes)

    return wrap
