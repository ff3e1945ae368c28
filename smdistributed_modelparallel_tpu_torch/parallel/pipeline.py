"""Pipeline parallelism of the PyTorch port: the partition and the stage
executor.

Counterpart of ``smdistributed_modelparallel_tpu/parallel/pipeline.py``. The
JAX package runs a pipeline as one SPMD program: a ``lax.scan`` over ticks
whose body ``vmap``s every stage and rolls the carry over the ``pp`` mesh
axis. The port runs one process a stage instead. Every rank walks the same
static grid of ticks; at each tick a stage runs its forward sub-step and
then its backward sub-step, and moves activations and cotangents to its
neighbours with point-to-point transfers over the pp group
(``TensorGroup.send``/``recv``):

- a forward F(s, m) of microbatch m on stage s posts its output to stage
  s + 1, which receives it at a strictly later tick of the grid;
- a backward B(s, m) posts the cotangent of the stage's input to stage
  s - 1, again received at a strictly later tick;
- sends are posted and never waited for inside the grid, and a stage
  receives only what the grid says has been sent, so no two neighbours
  block on each other.

A stage keeps the autograd graph of each microbatch in flight between its F
and its B (at most the schedule's window of them), and the backward is one
``torch.autograd.grad`` of the stage's output (the loss on the last stage)
with respect to the stage's parameters and its input. The JAX package
recomputes the stage forward under ``jax.vjp`` instead; the numbers are the
same (the forward is deterministic: keys drawn inside a stage are refused
here, ROADMAP item 8), and no layer runs its forward twice.

Who runs what. Stage 0 embeds each microbatch (``spec.embed_method``) from
the captured inputs of the user's single ``model(...)`` call; the stage's
layers run through ``spec.stage_method``; the last stage runs the user's step
function again with that call forced to the head (``spec.head_method``) of
its output, and differentiates the marked loss. Side inputs of a tuple carry
(``cross_states``, ``attention_mask``) do not travel: each stage takes them
from the embedding of the captured inputs. Every parameter the stage's work
did not touch gets no gradient here; the step sums the gradients of the
replicated (non-layer) parameters over the pp group.

Errors. Every transfer has a header on the pp group's gloo group that says
whether the sender failed first. A stage that raises (a usage error in the
step function, a refusal, a kernel error) or hears that its neighbour did
posts failure headers for all the transfers it still owed, so that no
neighbour stays blocked in a receive; at the step's end every stage meets
in one ``all_gather_object`` (``finish``), where the first failure is
raised on every rank, and the last stage's output tree reaches the others.

Partition. ``partition_for_pipeline`` picks contiguous per-stage layer
ranges with the JAX package's cost model (``parallel/module_partition.py``,
manual ``smp.set_partition("<layer_path>#<i>", stage)`` pins,
``auto_partition: False`` with ``default_partition``); a heterogeneous stack
is timed on the rank's device (CUDA events on a card). Rank 0 decides the
boundaries and broadcasts them over the world, so every rank runs the same
split. ``stage_layout`` and ``chunk_layout`` are the JAX package's grids.
"""

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import PP_AXIS
from smdistributed_modelparallel_tpu_torch.utils import exceptions as _exc
from smdistributed_modelparallel_tpu_torch.utils.exceptions import PartitionError, SMPRuntimeError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


@dataclass
class PipelineSpec:
    """How a module decomposes into embed -> repeated layer -> head.

    Attributes (the JAX package's, with the torch objects in place of the
    flax ones):
      layer_path: the JAX package's '/'-joined path of the layer stack
        ("layers/block"): the assignment's keys and the manual pins are
        "<layer_path>#<i>", as in the JAX package.
      num_layers: the layer count L.
      layer_module: the ``torch.nn.ModuleList`` of the L layers.
      embed_method / head_method: methods of the root module computing the
        carry before the layers and the output after them (``None``: the
        identity, the module IS the layer stack).
      stage_method: the root module's method ``(carry, start, end) ->
        carry`` that applies layers ``[start, end)`` (with their global
        indices, the per-layer inputs ``layer_xs`` among them).
      carry_remat, layer_xs, carry_is_tuple, layer_costs, boundaries,
        virtual_degree: as in the JAX package (``layer_xs`` as numpy).
      hidden_size, seq_len: the width and a sequence length to time one
        layer at (``_measured_layer_times``).
    """

    layer_path: str
    num_layers: int
    layer_module: Any
    embed_method: Optional[str] = "embed"
    head_method: Optional[str] = "head"
    stage_method: str = "apply_layers"
    carry_remat: bool = False
    layer_xs: Any = None
    carry_is_tuple: bool = False
    layer_costs: Optional[list] = None
    boundaries: Optional[list] = None
    virtual_degree: int = 1
    hidden_size: Optional[int] = None
    seq_len: Optional[int] = None


def get_pipeline_spec(module):
    fn = getattr(module, "pipeline_spec", None)
    if fn is None:
        return None
    return fn() if callable(fn) else fn


def partition_for_pipeline(model):
    """The stage assignment ``{"<layer_path>#<i>": stage}`` of a
    pipelineable model; installs ``model._pipeline_spec`` with its
    boundaries. Raises ``PartitionError`` for a module without
    ``pipeline_spec()`` and for fewer layers than stages, as the JAX
    package does."""
    cfg = state.cfg
    pp = cfg.pipeline_parallel_degree
    virtual = int(getattr(cfg, "virtual_pipeline_degree", 1) or 1)
    spec = get_pipeline_spec(model.module)
    if spec is None:
        raise PartitionError(
            "pipeline_parallel_degree > 1 requires a pipelineable model: one "
            "exposing pipeline_spec() (smp.nn.DistributedTransformer* and the "
            "smp model zoo do). Arbitrary module graphs cannot be pipelined "
            "under SPMD."
        )
    L = spec.num_layers
    nchunks = pp * virtual
    if L < nchunks:
        raise PartitionError(
            f"num_layers={L} < pipeline_parallel_degree * "
            f"virtual_pipeline_degree = {pp} * {virtual} = {nchunks}: at "
            "least one layer per chunk is required."
        )
    if not spec.carry_remat:
        mm = model.module_manager
        if getattr(model.module, "activation_checkpointing", False):
            spec.carry_remat = True
        else:
            for prefix in mm.checkpoint_configs:
                if prefix == "" or spec.layer_path.startswith(prefix):
                    spec.carry_remat = True
                    break
    spec.virtual_degree = virtual
    spec.boundaries = _agreed(lambda: _choose_boundaries(model, spec, nchunks))
    assignment = {}
    for c, (a, b) in enumerate(spec.boundaries):
        for layer in range(a, b):
            assignment[f"{spec.layer_path}#{layer}"] = c % pp
    model._pipeline_spec = spec
    logger.info("Pipeline partition: %d layers -> %d stages %s.", L, pp, [b - a for a, b in spec.boundaries])
    return assignment


def _agreed(decide):
    """``decide()`` on rank 0, broadcast over the world (a measured layer
    cost differs from one rank to the next): every rank gets rank 0's
    result, or raises its error."""
    import torch.distributed as dist

    if state.world_size <= 1 or not dist.is_initialized():
        return decide()
    box = [None]
    if state.rank == 0:
        try:
            box[0] = ("ok", decide())
        except Exception as e:  # every rank raises it
            box[0] = ("error", e)
    dist.broadcast_object_list(box, src=0)
    kind, value = box[0]
    if kind == "error":
        raise value
    return value


def _layer_cost_inputs(model, spec):
    """(param_bytes_per_layer, time_cost_per_layer) for the cost model: the
    JAX package's. Parameter bytes are the stack's over L (the JAX
    package's stacked leaves); time costs are ``spec.layer_costs``, else
    measured per distinct layer variant of a heterogeneous stack
    (``_measured_layer_times``), else uniform."""
    L = spec.num_layers
    pbytes = sum(p.numel() * p.element_size() for p in spec.layer_module.parameters()) / max(L, 1)
    times = list(spec.layer_costs) if spec.layer_costs else None
    if times is None:
        times = _measured_layer_times(model, spec)
    if times is None:
        times = [1.0] * L
    if len(times) != L:
        raise PartitionError(f"pipeline_spec.layer_costs has {len(times)} entries for {L} layers.")
    return [pbytes] * L, times


# Test hook: callable(sig, fn, args) -> seconds, replacing the timer.
_LAYER_TIMER = None


def _time_call(sig, fn, *args):
    """Best of three timed runs of ``fn(*args)`` after a warm one: CUDA
    events on a card, the wall clock on the CPU."""
    if _LAYER_TIMER is not None:
        return _LAYER_TIMER(sig, fn, args)
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    with torch.no_grad():
        fn(*args)
        best = float("inf")
        for _ in range(3):
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                best = min(best, time.perf_counter() - t0)
    return best


def _measured_layer_times(model, spec):
    """Per-layer time costs measured per distinct variant of the per-layer
    inputs, or None when measurement is off (``skip_tracing``) or pointless
    (a homogeneous stack), as in the JAX package. Runs on the caller's
    device (``_agreed`` calls it on rank 0 alone)."""
    cfg = state.cfg
    if cfg is None or cfg.skip_tracing or spec.layer_xs is None:
        return None
    xs_np = {k: np.asarray(v) for k, v in spec.layer_xs.items()}
    keys = sorted(k for k in xs_np if k != "layer_idx")
    if not keys:
        return None
    L = spec.num_layers
    sigs = [tuple(xs_np[k][i].item() for k in keys) for i in range(L)]
    if len(set(sigs)) < 2 or not spec.hidden_size:
        return None
    T = max(8, min(int(spec.seq_len or 128), 512))
    first = next(iter(spec.layer_module.parameters()))
    x = torch.zeros((2, T, spec.hidden_size), dtype=torch.float32, device=first.device)
    times_by_sig = {}
    for sig in sorted(set(sigs)):
        i = sigs.index(sig)
        layer = spec.layer_module[i]

        def fn(x, _layer=layer, _xs={k: xs_np[k][i].item() for k in keys}):
            return _layer(x, cross_states=None, attention_mask=None, layer_idx=0, **_xs)

        times_by_sig[sig] = _time_call(sig, fn, x)
    logger.info("Measured layer-variant costs: %s", {str(k): round(v, 6) for k, v in times_by_sig.items()})
    return [times_by_sig[s] for s in sigs]


def _choose_boundaries(model, spec, pp):
    """Contiguous per-stage layer ranges from costs + manual pins: the JAX
    package's rule."""
    from smdistributed_modelparallel_tpu_torch.parallel.module_partition import (
        ModuleNode,
        ModulePartitioner,
        min_max_segments_pinned,
    )

    cfg = state.cfg
    L = spec.num_layers
    pbytes, times = _layer_cost_inputs(model, spec)

    pins = {}
    for prefix, stage in model.module_manager.get_manual_partitions().items():
        if prefix.startswith(spec.layer_path + "#"):
            try:
                pins[int(prefix.rsplit("#", 1)[1])] = stage
            except ValueError:
                raise PartitionError(
                    f"Malformed layer pin '{prefix}': expected "
                    f"'{spec.layer_path}#<layer_index>'."
                )
    for idx, stage in pins.items():
        if not (0 <= idx < L):
            raise PartitionError(f"Pinned layer {idx} out of range [0, {L}).")

    if not cfg.auto_partition:
        default = cfg.default_partition
        if default is None or not (0 <= default < pp):
            raise PartitionError(
                f"auto_partition: False requires default_partition in "
                f"[0, {pp}) (got {default})."
            )
        stages = [pins.get(i, default) for i in range(L)]
        if any(b < a for a, b in zip(stages, stages[1:])):
            raise PartitionError(
                f"Manual partition produced a non-contiguous stage order "
                f"{stages}; the SPMD executor requires non-decreasing "
                "stage assignments along the layer sequence."
            )
        bounds = _runs(stages, pp)
        for s, (a, b) in enumerate(bounds):
            if a == b:
                raise PartitionError(
                    f"Manual partition leaves stage {s} empty "
                    f"(stages={stages}); every pipeline stage needs at "
                    "least one layer."
                )
        return bounds

    mw = cfg.memory_weight
    total_m = sum(pbytes) or 1.0
    total_t = sum(times) or 1.0
    blended = [mw * (m / total_m) + (1.0 - mw) * (t / total_t) for m, t in zip(pbytes, times)]
    if pins:
        return min_max_segments_pinned(blended, pp, pins)
    root = ModuleNode(name=spec.layer_path)
    root.children = [
        ModuleNode(name=f"{spec.layer_path}#{i}", param_bytes=pbytes[i], time=times[i])
        for i in range(L)
    ]
    assignment = ModulePartitioner(root, pp, memory_weight=mw).partition()
    stages = [assignment[f"{spec.layer_path}#{i}"] for i in range(L)]
    if any(b < a for a, b in zip(stages, stages[1:])):
        raise PartitionError(
            f"Partitioner produced a non-contiguous stage order {stages}; "
            "the SPMD executor requires contiguous stages."
        )
    bounds = _runs(stages, pp)
    if bounds[-1][1] != L:
        raise PartitionError(f"Partitioner left layers unassigned (stages={stages}).")
    return bounds


def _runs(stages, pp):
    """``[(start, end)]`` of each stage's run in a non-decreasing stage
    list."""
    bounds, start = [], 0
    for s in range(pp):
        end = start
        while end < len(stages) and stages[end] == s:
            end += 1
        bounds.append((start, end))
        start = end
    return bounds


def stage_layout(spec, num_stages):
    """(layer_index_grid [S, maxp], active_mask [S, maxp], maxp): the JAX
    package's grids of the stages' layers."""
    bounds = spec.boundaries
    L = spec.num_layers
    if bounds is None:
        per = L // num_stages
        bounds = [(s * per, (s + 1) * per) for s in range(num_stages)]
    maxp = max(b - a for a, b in bounds)
    idx = np.zeros((num_stages, maxp), np.int32)
    active = np.zeros((num_stages, maxp), bool)
    for s, (a, b) in enumerate(bounds):
        n = b - a
        idx[s, :n] = np.arange(a, b)
        active[s, :n] = True
    return idx, active, maxp


def chunk_layout(spec, num_stages, virtual):
    """(layer_index_grid [S, V, maxp], active_mask [S, V, maxp], maxp) of
    the interleaved placement: chunk ``c`` of ``spec.boundaries`` sits at
    ``[c % S, c // S]`` (stage, local chunk)."""
    C = num_stages * virtual
    if spec.boundaries is not None and len(spec.boundaries) != C:
        raise PartitionError(
            f"pipeline spec has {len(spec.boundaries)} chunk boundaries "
            f"for {num_stages} stages x {virtual} virtual chunks."
        )
    idx, active, maxp = stage_layout(spec, C)
    shape = (virtual, num_stages, maxp)
    return (idx.reshape(shape).transpose(1, 0, 2),
            active.reshape(shape).transpose(1, 0, 2), maxp)


# ----------------------------------------------------------------------
# Refusals
# ----------------------------------------------------------------------


def _item8(what):
    return NotImplementedError(
        f"{what} at pipeline_parallel_degree > 1 is not ported to PyTorch yet (ROADMAP item 8)."
    )


def check_supported(cfg, model=None):
    """Raise for what the port does not run at pp > 1 yet, each naming
    ROADMAP item 8 (the JAX package runs all of them)."""
    from smdistributed_modelparallel_tpu_torch.parallel import remat_plan
    from smdistributed_modelparallel_tpu_torch.utils import health

    if int(getattr(cfg, "virtual_pipeline_degree", 1) or 1) > 1:
        raise _item8("virtual_pipeline_degree > 1 (the interleaved virtual stages)")
    if cfg.pipeline == "zero_bubble":
        raise _item8('pipeline: "zero_bubble"')
    if remat_plan.resolve(cfg) != "full":
        raise _item8(f"recompute: {remat_plan.resolve(cfg)!r} (the pipeline's recompute plans)")
    if cfg.fp16:
        raise _item8("fp16 (the loss scaler's overflow flag over the pp group)")
    if health.mode() != "off":
        raise _item8("SMP_HEALTH_CHECK (the sentinel's word over the pp group)")
    topo = state.topology
    if topo is not None and topo.size > topo.pp_size:
        raise _item8(f"pp beside tensor, data, context or expert parallelism ({topo.size} ranks for "
                     f"{topo.pp_size} stages)")
    if model is None:
        return
    from smdistributed_modelparallel_tpu_torch.nn.moe import DistributedMoE

    if any(isinstance(m, DistributedMoE) for m in model.module.modules()):
        raise _item8("DistributedMoE (the load-balancing loss summed over the stages)")
    spec = model._pipeline_spec
    if spec is not None and spec.carry_remat:
        raise _item8("activation checkpointing inside the pipeline")


class OtherStageLayer(torch.nn.Module):
    """The place of layer ``index`` on a rank whose stage does not hold it
    (the layer's parameters are freed)."""

    def __init__(self, index):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise _item8(f"Calling layer {self.index}, which another pipeline stage holds, outside an @smp.step")

    def extra_repr(self):
        return f"index={self.index}"


def refuse_key(module, name):
    """A key drawn inside a pipelined step (dropout): refused."""
    raise _item8(f"{type(module).__name__} drawing a {name!r} key inside a stage (dropout)")


# ----------------------------------------------------------------------
# The stage executor
# ----------------------------------------------------------------------

FWD, BWD = 0, 1


def _tag(run, m, direction, header):
    """The transfer's tag: the executor's run (mod 1024, so that a transfer
    a failed step left unmatched never meets a later step's), the
    microbatch, whether it is a header, and the direction (the low bit:
    ``TensorGroup.send`` picks the backward group by it)."""
    return ((run % 1024) << 20) | (m << 2) | (int(header) << 1) | direction


# A transfer's header: [failed, dtype code, ndim, dims...] (int32).
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_HEADER = 3 + 8


def _header(failed, x=None):
    h = torch.zeros((_HEADER,), dtype=torch.int32)
    h[0] = failed
    if x is not None:
        h[1], h[2] = _DTYPES.index(x.dtype), x.dim()
        h[3:3 + x.dim()] = torch.tensor(x.shape, dtype=torch.int32)
    return h


# The posted sends of failed steps (kept alive, never waited for).
_ABANDONED = []


class _PeerFailed(Exception):
    """A neighbour's header said it failed."""


class _Graph:
    """One microbatch in flight on a stage: its input (requires grad), its
    output (or the last stage's differentiated loss)."""

    __slots__ = ("x_in", "out")

    def __init__(self, x_in, out):
        self.x_in, self.out = x_in, out


class _Binder(torch.nn.Module):
    """``torch.func.functional_call`` target that runs a function of the
    root module on the step's bound parameters."""

    def __init__(self, root):
        super().__init__()
        self.root = root

    def forward(self, fn):
        return fn()


class StageExecutor:
    """This rank's stage of one pipelined step.

    Args:
      model: the ``DistributedModel`` (``_pipeline_spec`` installed).
      bound: {name: tensor} the step binds (half casts, requiring grad).
      inputs: [(args, kwargs)] the captured model-call inputs a microbatch.
      loss_fn(m, head) -> (differentiated, user_out): the step function of
        microbatch m run with the model call forced to ``head()`` (the last
        stage only).
      backward: whether the step differentiates.
      seed: the scale of the last stage's loss seed.
    """

    runs = 0

    def __init__(self, model, bound, inputs, loss_fn, backward, seed):
        self.model, self.spec = model, model._pipeline_spec
        self.root = model.module
        self.group = state.group(PP_AXIS)
        self.S, self.s = self.group.size, self.group.index
        self.first, self.last = self.s == 0, self.s == self.S - 1
        self.start, self.end = self.spec.boundaries[self.s]
        self.bound, self.inputs, self.loss_fn = bound, inputs, loss_fn
        self.backward, self.seed = backward, seed
        self.names = [n for n, t in bound.items() if t.requires_grad]
        self.params = [bound[n] for n in self.names]
        self.binder = _Binder(self.root)
        self.prefixed = {"root." + n: t for n, t in bound.items()}
        StageExecutor.runs += 1  # every stage makes one a step, failed steps too
        self.run_id = StageExecutor.runs
        self.inflight = {}
        self.acc = None
        self.outs = {}          # m -> user output (last stage)
        self.pending = []       # posted sends, waited for at the step's end
        self.owed = []          # (peer, tag) of the headers this stage still owes
        self.device = model.device
        self.comm_s = 0.0       # host seconds in the transfers
        self.transfers = 0

    def _bind(self, fn):
        return torch.func.functional_call(self.binder, self.prefixed, (fn,))

    # -- transfers ----------------------------------------------------------

    def _send(self, x, peer, m, direction):
        t0 = time.perf_counter()
        tag = _tag(self.run_id, m, direction, True)
        self.owed.remove((peer, tag))
        self.pending.append(self.group.send_status(_header(0, x), peer, tag))
        self.pending.append(self.group.send(x.detach(), peer, _tag(self.run_id, m, direction, False)))
        self.comm_s += time.perf_counter() - t0
        self.transfers += 1

    def _recv(self, peer, m, direction):
        t0 = time.perf_counter()
        header = self.group.recv_status(_HEADER, peer, _tag(self.run_id, m, direction, True)).tolist()
        if header[0] != 0:
            raise _PeerFailed()
        shape, dtype = tuple(header[3:3 + header[2]]), _DTYPES[header[1]]
        x = self.group.recv(shape, dtype, peer, _tag(self.run_id, m, direction, False), self.device)
        self.comm_s += time.perf_counter() - t0
        return x

    def _fail_owed(self):
        """Post a failure header for every transfer this stage still owes."""
        failed = _header(1)
        for peer, tag in self.owed:
            self.pending.append(self.group.send_status(failed, peer, tag))
        self.owed = []

    # -- sub-steps ----------------------------------------------------------

    def _sides(self, m):
        """The side inputs of a tuple carry for microbatch m, from the
        embedding of its captured inputs (computed, never differentiated)."""
        if not self.spec.carry_is_tuple:
            return ()
        with torch.no_grad():
            return tuple(self._embed(m)[1:])

    def probe(self, run_fn):
        """``run_fn(value)`` (the step function of microbatch 0 with its
        model call answered by ``value()``) on the bound parameters, without
        gradients; ``value`` is the head of the embedding, no layer run: what
        the step learns whether the function calls ``model.backward`` from,
        on every stage alike."""
        with torch.no_grad():
            return self._bind(lambda: run_fn(lambda: self._head(self._embed(0))))

    def _embed(self, m):
        args, kwargs = self.inputs[m]
        if self.spec.embed_method is None:
            return args[0]
        return getattr(self.root, self.spec.embed_method)(*args, **kwargs)

    def _head(self, carry):
        if self.spec.head_method is None:
            return carry[0] if self.spec.carry_is_tuple else carry
        return getattr(self.root, self.spec.head_method)(carry)

    def forward(self, m, x_in):
        """F(s, m): returns the stage output's hidden (or, on the last
        stage, records the user output)."""

        def run():
            if self.first:
                carry = self._embed(m)
            else:
                carry = (x_in,) + self._sides(m) if self.spec.carry_is_tuple else x_in
            carry = getattr(self.root, self.spec.stage_method)(carry, self.start, self.end)
            if not self.last:
                return carry[0] if self.spec.carry_is_tuple else carry
            differentiated, user_out = self.loss_fn(m, lambda: self._head(carry))
            self.outs[m] = user_out
            return differentiated

        with torch.enable_grad() if self.backward else torch.no_grad():
            out = self._bind(run)
        if self.backward:
            self.inflight[m] = _Graph(x_in, out)
        return out

    def backward_step(self, m, cot):
        """B(s, m): accumulates the parameter gradients; returns the
        cotangent of the stage input (None on stage 0)."""
        g = self.inflight.pop(m)
        if self.last:
            roots, gouts = [g.out * self.seed], None
        else:
            roots, gouts = [g.out], [cot]
        inputs = self.params + ([g.x_in] if not self.first else [])
        grads = torch.autograd.grad(roots, inputs, gouts, allow_unused=True)
        if self.acc is None:
            fp32 = state.cfg._fp32_grad_accumulation
            master = dict(self.root.named_parameters())
            self.acc = {n: torch.zeros(p.shape, dtype=torch.float32 if fp32 else master[n].dtype, device=p.device)
                        for n, p in zip(self.names, self.params)}
        for n, gr in zip(self.names, grads):
            if gr is not None:
                self.acc[n].add_(gr)
        if self.first:
            return None
        dx = grads[-1]
        return dx if dx is not None else torch.zeros_like(g.x_in)

    # -- the grid -----------------------------------------------------------

    def run(self, ticks):
        """Walk ``ticks``: this stage's ``(forward microbatch, backward
        microbatch)`` of every tick of the grid (-1: idle). Returns the
        error this stage met (None when it ran through)."""
        s = self.s
        for f, b in ticks:  # every transfer this stage will send, in grid order
            if f >= 0 and not self.last:
                self.owed.append((s + 1, _tag(self.run_id, f, FWD, True)))
            if b >= 0 and not self.first:
                self.owed.append((s - 1, _tag(self.run_id, b, BWD, True)))
        try:
            for f, b in ticks:
                if f >= 0:
                    x_in = None
                    if not self.first:
                        x_in = self._recv(s - 1, f, FWD)
                        if self.backward:
                            x_in.requires_grad_()
                    out = self.forward(f, x_in)
                    if not self.last:
                        self._send(out, s + 1, f, FWD)
                if b >= 0:
                    cot = None if self.last else self._recv(s + 1, b, BWD)
                    dx = self.backward_step(b, cot)
                    if dx is not None:
                        self._send(dx, s - 1, b, BWD)
            return None
        except _PeerFailed as e:
            self._fail_owed()
            return e
        except Exception as e:  # noqa: BLE001 - reaches every stage at finish()
            self._fail_owed()
            return e
        finally:
            self.inflight.clear()

    def finish(self, error, out_meta):
        """The step's end on every stage: one ``all_gather_object`` of each
        stage's failure (or None) and the last stage's output meta; raises
        the first failure on every rank, else waits for this stage's sends
        and returns the last stage's meta."""
        mine = None
        if error is not None and not isinstance(error, _PeerFailed):
            mine = (type(error).__name__, str(error))
        try:
            gathered = self.group.all_gather_object((mine, out_meta if self.last else None))
        except Exception:
            if error is not None and not isinstance(error, _PeerFailed):
                raise error
            raise
        if error is not None or any(fail is not None for fail, _ in gathered):
            # A send to a stage that failed may never be received: its
            # buffer stays alive with the process, and nothing waits for it.
            _ABANDONED.extend(self.pending)
            self.pending = []
        for stage, (fail, _) in enumerate(gathered):
            if fail is not None:
                if stage == self.s and error is not None:
                    raise error
                raise _rebuild(stage, *fail)
        if error is not None:
            raise SMPRuntimeError("a pipeline stage failed without saying why") from error
        for work in self.pending:
            work.wait()
        self.pending = []
        return gathered[-1][1]


def _rebuild(stage, cls_name, message):
    """The exception pipeline stage ``stage`` raised, raised again here:
    the same class where it is one of the port's or a builtin that takes a
    message, else ``SMPRuntimeError``."""
    import builtins

    cls = getattr(_exc, cls_name, None) or getattr(builtins, cls_name, None)
    text = f"pipeline stage {stage}: {message}"
    if isinstance(cls, type) and issubclass(cls, Exception):
        try:
            return cls(text)
        except TypeError:
            pass
    return SMPRuntimeError(f"pipeline stage {stage} raised {cls_name}: {message}")


def fill_drain_ticks(S, M, s, backward):
    """Stage s's ticks of the fill-drain grid (stage s runs microbatch t - s
    at tick t), then, with ``backward``, the same grid in reverse for the
    backward (B(s, m) at the reverse of F(s, m)'s tick): the JAX package's
    ``pipeline_forward`` under ``jax.value_and_grad``."""
    n = M + S - 1
    ticks = [((t - s) if 0 <= t - s < M else -1, -1) for t in range(n)]
    if backward:
        ticks += [(-1, f) for f, _ in reversed(ticks)]
    return ticks


def pipeline_forward(executor):
    """The fill-drain executor (``pipeline: "simple"``, and every step
    without ``model.backward``): every microbatch forward in the fill-drain
    grid, then, for a training step, their backwards in the reverse grid.
    Records the JAX package's occupancy gauges (``fill_drain``). Returns the
    stage's error, if any."""
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_pipeline_occupancy

    S, M = executor.S, state.cfg.microbatches
    n_ticks = M + S - 1
    record_pipeline_occupancy("fill_drain", S, M, busy_slots=M * S, total_slots=n_ticks * S)
    flight_recorder.record_schedule(
        "fill_drain", ((t, s, "fwd", t - s) for t in range(n_ticks) for s in range(S) if 0 <= t - s < M))
    return executor.run(fill_drain_ticks(S, M, executor.s, executor.backward))
