"""Activation checkpointing and host offloading of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/parallel/memory.py``
(``remat_policy``, ``offload_supported``, ``name_layer_activation``,
``checkpoint``, ``checkpoint_sequential``, ``module_checkpoint_enabled``).
The JAX package wraps a layer in ``jax.checkpoint`` with a policy; here a
checkpointed region runs through ``torch.utils.checkpoint`` in its
non-reentrant form (the step differentiates with ``torch.autograd.grad``,
which the reentrant form does not support), and the policy decides what the
region keeps for its backward:

- ``recompute: full`` (the default): only the region's inputs; everything
  else is recomputed in the backward (JAX: policy None);
- ``stash_weight`` and ``auto``: also the outputs of the weight products,
  ``aten.mm`` and ``aten.addmm`` (2-D operands, no batch dimension), through
  torch's selective-checkpoint contexts (JAX:
  ``dots_with_no_batch_dims_saveable``). A product that is not an aten
  matrix op is recomputed, as a ``pallas_call`` is under the JAX policy: the
  fused QKV's ``ops/matmul_bias`` kernel on the card, and the batched
  products of the plain attention path;
- ``stash_all``: everything, so the region runs as it would without
  checkpointing and recomputes nothing (JAX: ``everything_saveable``);
- ``offload_activations`` (over ``recompute``, as in the JAX package): the
  region's inputs go to pinned host memory (``Offloader``) and everything
  else is recomputed. In the backward, ``activation_loading_horizon`` inputs
  are brought back ahead of their region on a side stream; at horizon 0 the
  copies are synchronous. A CPU tensor already lies in host memory and stays
  as it is; a CUDA tensor is copied or the copy raises, never kept on the
  device instead.

A region's recompute runs in the step's backward, after the microbatch has
ended: ``state.calling_model`` is gone, the model's parameters are no longer
bound to the step's half casts, and the fp8 trace is thread-local (the
autograd engine runs a CUDA backward on its own thread). So the recompute
context restores what the forward saw (``_Replay``): the calling model, the
random keys its modules drew, in order (``DistributedModel.make_rng`` records
and replays them), the fp8 trace and, for a module, the parameter tensors it
ran on. The recompute therefore draws the forward's dropout masks and
quantizes with the step's scales; its amax observations fold into the step's
running max again with the same values, so the finalized quant state is
unchanged. A ``DistributedMoE`` in the region records its load-balancing loss
in the forward only: the model takes none while keys replay
(``DistributedModel._sow_moe_aux``). A decoder layer's ``cross_states`` reach
the region as a keyword argument, so the recompute reads the same tensor and
the gradient reaches the encoder through every layer.

Not ported yet: the pipeline executors' ring plans (``zero_bubble_ring_plan``,
``recompute_ring_plan``; the pipeline slice).
"""

import contextlib
import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.parallel import remat_plan
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPRuntimeError

FULL, SELECTIVE, SAVE_ALL, OFFLOAD = "full", "selective", "save_all", "offload"

# Bytes the offloaders moved, for a caller to read (chip_smoke.py phase M).
offload_stats = {"to_host": 0, "to_device": 0, "prefetched": 0}


def offload_supported():
    """Whether pinned host memory exists to offload to: a CUDA device."""
    return torch.cuda.is_available()


def _is_cuda(t):
    return t.is_cuda


class RematPolicy:
    """What a checkpointed region keeps: ``kind`` one of FULL, SELECTIVE,
    SAVE_ALL, OFFLOAD; ``horizon`` the offload prefetch depth."""

    def __init__(self, kind, horizon=0):
        self.kind = kind
        self.horizon = horizon


def remat_policy():
    """The policy the config asks for: ``offload_activations`` first, then
    ``recompute`` (``remat_plan.resolve``): "full" -> FULL, "stash_weight"
    and "auto" -> SELECTIVE, "stash_all" -> SAVE_ALL."""
    cfg = state.cfg
    if cfg is None:
        return RematPolicy(FULL)
    if cfg.offload_activations:
        return RematPolicy(OFFLOAD, cfg.activation_loading_horizon)
    mode = remat_plan.resolve(cfg)
    if mode in ("stash_weight", "auto"):
        return RematPolicy(SELECTIVE)
    if mode == "stash_all":
        return RematPolicy(SAVE_ALL)
    return RematPolicy(FULL)


def name_layer_activation(x):
    """The JAX package tags a layer's output for its offload policy. Eager
    PyTorch has no tags: a checkpointed region's inputs are the boundary the
    offload policy moves, so this is the identity, kept for the API."""
    return x


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The selective policy: keep the weight products' outputs, recompute
    the rest."""
    if op in _SAVED_PRODUCTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


class _Replay:
    """What a region's forward saw, restored around its recompute: the
    calling model (and the keys its modules draw, recorded in the forward and
    replayed in order), the fp8 trace, and ``recomputing`` for the region's
    callables to bind their parameters."""

    def __init__(self):
        self.model = state.calling_model
        self.trace = quant.current_trace()
        self.keys = []
        self.recomputing = False

    @contextlib.contextmanager
    def forward(self):
        if self.model is None:
            yield
            return
        with self.model.recording_keys(self.keys):
            yield

    @contextlib.contextmanager
    def recompute(self):
        outer_model, state.calling_model = state.calling_model, self.model
        self.recomputing = True
        try:
            with quant.use_trace(self.trace), (self.model.replaying_keys(self.keys) if self.model is not None
                                               else contextlib.nullcontext()):
                yield
        finally:
            self.recomputing = False
            state.calling_model = outer_model


@contextlib.contextmanager
def _nested(outer, inner):
    with outer, inner:
        yield


def _contexts(policy, replay):
    """``torch.utils.checkpoint``'s ``context_fn``: the forward and the
    recompute contexts, which torch enters itself when it runs each."""
    if policy.kind != SELECTIVE:
        return replay.forward(), replay.recompute()
    sac_fwd, sac_rec = torch_checkpoint.create_selective_checkpoint_contexts(_save_weight_products)
    return _nested(replay.forward(), sac_fwd), _nested(replay.recompute(), sac_rec)


def _bind(fn, replay):
    """``fn``, and for a module, called in the recompute on the parameter
    tensors it runs on now (the step's half casts, inside a step)."""
    if not isinstance(fn, torch.nn.Module):
        return fn
    tensors = {**dict(fn.named_parameters()), **dict(fn.named_buffers())}

    def run(*args, **kwargs):
        if replay.recomputing:
            return torch.func.functional_call(fn, tensors, args, kwargs)
        return fn(*args, **kwargs)

    return run


class _Handle:
    """One offloaded tensor: its pinned host copy and the event of the copy,
    and once brought back, the device tensor and the event of that copy."""

    __slots__ = ("index", "host", "device", "copied", "loaded", "ready")

    def __init__(self, index, host, device, copied):
        self.index, self.host, self.device, self.copied = index, host, device, copied
        self.loaded = self.ready = None


class Offloader:
    """The offload policy's saved-tensor hooks for one forward: ``pack``
    copies a CUDA tensor to pinned host memory on a side stream (one event a
    copy) and keeps only that copy; ``unpack`` brings it back, and brings the
    ``horizon`` tensors packed before it (the next ones the backward needs)
    ahead on another side stream. At horizon 0 both copies are synchronous
    and nothing is prefetched."""

    def __init__(self, horizon):
        self.horizon = horizon
        self.handles = []
        self._streams = {}

    def _stream(self, name, device):
        s = self._streams.get(name)
        if s is None:
            s = self._streams[name] = torch.cuda.Stream(device)
        return s

    def pack(self, t):
        if not _is_cuda(t):
            return t  # already in host memory
        try:
            host = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=t.is_cuda)
        except RuntimeError as e:
            raise SMPRuntimeError(f"offload_activations: no pinned host memory for a {tuple(t.shape)} "
                                  f"{t.dtype} layer input ({e}).") from e
        copied = None
        if t.is_cuda and self.horizon:
            side = self._stream("to_host", t.device)
            side.wait_stream(torch.cuda.current_stream(t.device))
            with torch.cuda.stream(side):
                host.copy_(t, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            t.record_stream(side)  # its memory is reused only after the copy
        else:
            host.copy_(t)
        offload_stats["to_host"] += t.numel() * t.element_size()
        h = _Handle(len(self.handles), host, t.device, copied)
        self.handles.append(h)
        return h

    def _load(self, h, prefetch):
        """Start bringing ``h`` back: on the side stream when prefetching,
        else on the current stream."""
        if h.loaded is not None or h.host is None:
            return
        offload_stats["prefetched"] += prefetch
        if not h.device.type == "cuda":  # a CPU tensor sent down this path by a test
            h.loaded = h.host.clone()
        elif prefetch:
            side = self._stream("to_device", h.device)
            side.wait_event(h.copied)
            with torch.cuda.stream(side):
                h.loaded = h.host.to(h.device, non_blocking=True)
                h.ready = torch.cuda.Event()
                h.ready.record(side)
        else:
            if h.copied is not None:
                torch.cuda.current_stream(h.device).wait_event(h.copied)
            h.loaded = h.host.to(h.device, non_blocking=bool(self.horizon))
        offload_stats["to_device"] += h.host.numel() * h.host.element_size()

    def unpack(self, h):
        if not isinstance(h, _Handle):
            return h
        self._load(h, prefetch=False)
        for j in range(h.index - 1, max(h.index - 1 - self.horizon, -1), -1):
            self._load(self.handles[j], prefetch=True)
        t = h.loaded
        if h.ready is not None:
            current = torch.cuda.current_stream(h.device)
            current.wait_event(h.ready)
            t.record_stream(current)
        h.loaded = h.host = None  # each saved input is read once a backward
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)


def run_checkpointed(fn, args, kwargs=None, policy=None, offloader=None):
    """``fn(*args, **kwargs)`` as one checkpointed region under ``policy``
    (``remat_policy()`` when None). Under OFFLOAD the region's tensor
    arguments go through ``offloader`` (a new one when None)."""
    kwargs = kwargs or {}
    policy = policy or remat_policy()
    if policy.kind == SAVE_ALL or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if state.cp_sharded:
        raise NotImplementedError(
            "activation checkpointing under context parallelism is not ported to PyTorch yet (ROADMAP Queue 1 "
            "item 6: what context parallelism left behind)."
        )
    if state.cfg is not None and state.cfg.tensor_parallel_degree > 1:
        raise NotImplementedError(
            "activation checkpointing at tensor_parallel_degree > 1 is not ported to PyTorch yet (ROADMAP item 7b)."
        )
    replay = _Replay()
    run = functools.partial(torch_checkpoint.checkpoint, _bind(fn, replay), *args, use_reentrant=False,
                            context_fn=functools.partial(_contexts, policy, replay), **kwargs)
    if policy.kind != OFFLOAD:
        return run()
    with (offloader or Offloader(policy.horizon)).hooks():
        return run()


def checkpoint(fn, *args, **kwargs):
    """``smp.checkpoint``: run ``fn`` as a checkpointed region under
    ``remat_policy()``. Two call forms: ``smp.checkpoint(fn)(args...)``
    (decorator) or ``smp.checkpoint(fn, args...)`` (immediate, the
    reference's ``smp.checkpoint(module, *args)``). A module runs its
    recompute on the parameter tensors of its forward."""
    if args or kwargs:
        return run_checkpointed(fn, args, kwargs)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        return run_checkpointed(fn, a, k)

    return wrapped


def checkpoint_sequential(fns, input, strategy="each"):
    """``smp.checkpoint_sequential``: ``fns`` applied in turn to ``input``,
    each one (``"each"``) or each group of N (``"group_N"``) a checkpointed
    region. Under the offload policy every region's input is offloaded, and
    the backward prefetches them as one stack."""
    if strategy == "each":
        group = 1
    elif strategy.startswith("group_"):
        group = int(strategy.split("_", 1)[1])
    else:
        raise ValueError(f"Unknown checkpoint_sequential strategy {strategy!r}")
    policy = remat_policy()
    offloader = Offloader(policy.horizon) if policy.kind == OFFLOAD else None
    fns = list(fns)
    x = input
    for i in range(0, len(fns), group):
        x = run_checkpointed(_Chain(fns[i:i + group]), (x,), policy=policy, offloader=offloader)
    return x


class _Chain(torch.nn.Module):
    """Callables applied in turn; the modules among them are its children,
    so their parameters are bound in the recompute as one module's."""

    def __init__(self, fns):
        super().__init__()
        self.fns = fns
        self.mods = torch.nn.ModuleList(f for f in fns if isinstance(f, torch.nn.Module))

    def forward(self, x):
        for f in self.fns:
            x = f(x)
        return x


def module_checkpoint_enabled(mm, *paths):
    """Whether any of the given module paths has an activation-checkpoint
    config registered (``smp.set_activation_checkpointing``)."""
    if mm is None:
        return False
    return any(mm.checkpoint_config(p) is not None for p in paths)
