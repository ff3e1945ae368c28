"""``smp.DistributedModel`` of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/model.py`` for one device:
it wraps a ``torch.nn.Module``, places it on its device and exposes
``module``, ``state_dict``/``load_state_dict``, ``generate`` and the
training surface: ``backward`` inside an ``@smp.step`` function, ``grads``
after it, ``parameters``/``num_parameters`` and ``train``/``eval``. Inside
a step, ``model(...)`` runs the module on the parameters the step engine
bound for the microbatch (half casts of the fp32 master parameters under
bf16/fp16), and ``model.backward(loss)`` marks the loss that the engine
differentiates. Under context, data or expert parallelism (cp, rdp or ep >
1) the parameters and buffers are broadcast from the first rank of the data
group (``topology.DATA_AXES``) at build, and inside a step that runs this
rank's rows (rdp or ep > 1) a key drawn for a module raises (each rank would
need its rows' part of the global mask). At ep > 1 every ``DistributedMoE``
keeps the ep rank's experts (``shard_experts``), which are broadcast only over
the ranks that hold the same experts (``EXPERT_REPLICA_AXES``, rdp x cp);
``_expert_params`` names them for the step's gradient reduction. Pipeline
parallelism arrives with a later slice.

Tensor parallelism (tp > 1). The ``smp.nn`` layers cut their tp-sharded
parameters to the rank's part when they are built (``nn/utils.
shard_parameters_``); ``_tp_specs`` names them with their ``TPSpec``. The
data-group broadcast leaves the tp ranks' shards as they are (tp is not a
data axis), and replicated parameters start equal on every tp rank because
every rank draws the same full model. The reference layout stays the
unsharded one: ``reference_state_dict()`` (and the optimizer's) gathers the
shards over tp first, and every load (``load_state_dict`` with torch's,
the reference's or a shard payload, a resume, ``load_sharded``) takes whole
tensors and keeps the rank's part, so a tp = 1 model's state loads at tp = 2
and back. ``tp_pieces()`` gives, for a partial checkpoint, the region of each
reference leaf this tp rank writes. Under ``optimize: "memory"`` a layer
stack that runs its residual stream sharded along T notes it
(``_note_sequence_parallel``): its replicated parameters (``_stack_replicated``,
the layernorms and row-parallel biases) then saw this rank's tokens only, and
the step sums their gradients over tp. At tp > 1 every rank draws the keys
a tp = 1 step draws, and a shard draws its part of each mask
(``nn/utils.dropout``).

Random keys. ``rngs`` names the key streams the module draws from besides
its parameters (``("dropout",)``, as in the JAX package). Inside a step the
engine hands each microbatch one key a stream; ``make_rng`` (which
``nn/utils.make_rng`` calls for the model being called) gives a module its
flax scope key from it: the module's path in the flax tree (the
torch attribute names, with a layer stack's ``ModuleList`` entry i read as
the flax ``nn.scan`` body at split index i) and a per-call counter that
restarts with each model call, as flax's ``apply`` does. Outside a step
there is no key, and a module that draws one raises, as flax's
``make_rng`` does in the JAX package.

Distribution. Before the module moves to its device, ``nn/auto_distribute.
distribute_tree`` swaps its tp-marked modules (``smp.tensor_parallelism()``,
``smp.set_tensor_parallelism``) for their registered ``smp.nn`` counterparts
(``_tp_replaced`` lists their paths), records ``smp.partition`` stamps in the
module manager (``module_manager``), and turns on the
``activation_checkpointing`` flag of every module that a config registered
with ``smp.set_activation_checkpointing`` touches (the JAX package's rule,
``_ckpt_config_touches``). A module whose parameters are on the meta device
(``smp.from_hf`` builds one) is placed empty on the device and filled from
the state ``smp.from_hf`` or a resume staged. A checkpointed region
(``parallel/memory``) records the keys ``make_rng`` gives in its forward and
replays them in its recompute, which runs in the step's backward after the
microbatch has ended.

Mixture of experts. Each ``DistributedMoE`` forward of a model call inside a
step records its load-balancing loss here (``_sow_moe_aux``), as the JAX
package's apply collects the sown ``moe_aux_loss``; ``_end_microbatch`` adds
their sum times ``moe_aux_loss_weight`` to the loss the step differentiates,
and the step returns the loss as marked. Outside a step nothing is recorded.
The folded term is also kept apart (``_aux_term``): over several data ranks
each rank's aux is its part of the JAX package's global sum (``nn/moe.py``),
and the step weighs it by the data degree rather than by the rank's share of
the loss.

Checkpoints. ``state_dict()`` is torch's own. The checkpoint files hold the
JAX package's layout instead, so that either package resumes the other's
runs: ``reference_state_dict()`` is the flat '/'-keyed dict of numpy arrays
that the JAX package's ``DistributedModel.state_dict()`` gives for the same
model (``convert.params_to_jax`` for the zoo's ``TransformerLM``,
``convert.lm_head_params_to_jax`` for ``smp.nn.DistributedTransformerLMHead``,
``convert.encdec_params_to_jax`` for the zoo's ``EncoderDecoderLM``,
``convert.transformer_params_to_jax`` for a bare ``DistributedTransformer``;
any other module keeps its torch names), and ``local_state_dict()`` the same
as a shard payload (``shard_io``). ``load_state_dict`` takes any of the three,
and ``load_sharded`` a ``shard_io`` catalog. A checkpoint that
``smp.resume_from_checkpoint`` read before the model existed is applied when
the model is built, before any ``register_post_partition_hook`` hook runs.

Dispatch counters. The JAX package counts the layers' fused-kernel and fp8
dispatch decisions while it traces (``smp_fused_kernel_dispatch_total``,
``smp_quant_dispatch_total``); the port notes them as it runs
(``nn/utils.program_tick``) and ``replay_program_ticks`` ticks them as often
as the JAX package's traces would. A call outside a step is an eager flax
apply there, traced anew every call: each noted decision ticks once a trace,
and the model's first use (a lazy init, then the apply) traces twice.
"""

import contextlib

import torch

from smdistributed_modelparallel_tpu_torch import convert
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import DATA_AXES, EP_AXIS, EXPERT_REPLICA_AXES
from smdistributed_modelparallel_tpu_torch.nn.utils import collect_program_ticks, tp_group, tp_param_specs, tp_rank
from smdistributed_modelparallel_tpu_torch.utils import random
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPRuntimeError,
    SMPValidationError,
    StepUsageError,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


def resolve_device(device):
    """``None`` means the device ``smp.init`` named, else ``"cuda"``. A CUDA
    device that is absent is an error, never a quiet move to the CPU."""
    dev = torch.device(device or state.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SMPRuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU."
        )
    return dev


class DistributedModel:
    """Wraps a ``torch.nn.Module`` on one device.

    Args:
      module: the model, e.g. a ``TransformerLM`` from the zoo.
      device: where it runs; ``None`` resolves as ``resolve_device`` says.
      rngs: the key streams the module draws from.
      translate_functions: ``(to_hf, from_hf)`` state-dict translators of
        this model (``smp.from_hf`` sets them); a full checkpoint saved with
        ``translate_if_full`` goes through ``to_hf``.
    """

    def __init__(self, module, device=None, rngs=("dropout",), translate_functions=None):
        from smdistributed_modelparallel_tpu_torch.module_manager import ModuleManager
        from smdistributed_modelparallel_tpu_torch.nn.auto_distribute import distribute_tree

        if state.cfg is None:
            raise SMPValidationError("Call smp.init(config) before DistributedModel().")
        self.device = resolve_device(device)
        self._translate_functions = translate_functions
        # Annotations made before the model (smp.set_tensor_parallelism, ...)
        # live in the manager smp.* created.
        self.module_manager = state.module_manager = state.module_manager or ModuleManager()
        module, self._tp_replaced = distribute_tree(module, self.module_manager, state.tp_registry)
        self._expert_params = _shard_experts(module)
        if any(p.is_meta for p in module.parameters()):
            if state.loaded_model_state is None:
                raise SMPValidationError("The module's parameters are on the meta device and no state is staged to "
                                         "fill them (smp.from_hf or smp.resume_from_checkpoint stages one).")
            self.module = module.to_empty(device=self.device)
        else:
            self.module = module.to(self.device)
        self.rng_streams = tuple(rngs)
        self._rngs = None           # {stream: key} of the current microbatch
        self._rng_counts = {}       # make_rng calls of this model call, by (layer, scope path)
        self._layer_keys = {}       # (stream, layer) -> the stream key split for that layer
        self._key_tapes = []        # keys drawn are appended to each (checkpointed regions' forwards)
        self._key_replay = None     # iterator of the keys a recompute draws instead
        self._rng_scopes = _rng_scopes(self.module)
        # Parameters are replicated over the data ranks (an ep rank's experts
        # over the ranks that hold the same ones): every rank starts from its
        # group's first rank's.
        params = dict(self.module.named_parameters())
        for axes, tensors in ((DATA_AXES, [p for n, p in params.items() if n not in self._expert_params]
                               + list(self.module.buffers())),
                              (EXPERT_REPLICA_AXES, [params[n] for n in sorted(self._expert_params)])):
            group = state.group(axes)
            if group is not None and tensors:
                group.flat_(group.broadcast, tensors)
        self._grads = None          # {name: grad} of the last training step
        self._grads_finite = None   # bool under fp16 loss scaling
        self._bound = None          # {name: tensor} bound for the current microbatch
        self._backward_loss = None
        self._moe_aux = []          # MoE load-balancing losses of the current microbatch
        self._aux_term = None       # their folded term in the last _end_microbatch's loss
        self._param_version = 0     # bumped whenever the parameters change
        self._params_at_step = None
        self._dropped_updates = 0
        self._program_ticked = False  # the JAX package's lazy init has been traced (replay_program_ticks)
        self._health_leaf_groups = None  # the sentinel's JAX leaves (health.jax_leaf_groups)
        self._tp_specs = tp_param_specs(self.module)
        self._stack_replicated = _stack_replicated(self.module, self._tp_specs)
        self._seq_parallel_ran = False  # a layer stack ran sequence-parallel in this step
        self._tp_pieces = None  # tp_pieces(), computed at the first partial save
        self._to_reference, self._from_reference = _reference_layout(self.module)
        if self._tp_specs:
            self._to_reference, self._from_reference = self._tp_layout(self._to_reference, self._from_reference)
        state.model = self
        if state.loaded_model_state is not None:
            from smdistributed_modelparallel_tpu_torch.shard_io import ShardCatalog

            logger.info("Applying deferred checkpoint state to model.")
            payload, state.loaded_model_state = state.loaded_model_state, None
            if isinstance(payload, ShardCatalog):
                self.load_sharded(payload)
            else:
                self.load_state_dict(payload)

    def __call__(self, *args, **kwargs):
        self._rng_counts = {}  # each call is a fresh flax apply
        outer, state.calling_model = state.calling_model, self  # whose keys make_rng reads
        try:
            if self._bound is not None:
                return torch.func.functional_call(self.module, self._bound, args, kwargs)
            with collect_program_ticks() as notes:
                out = self.module(*args, **kwargs)
            first = self._first_program()
            replay_program_ticks(notes, lambda kind, phase: 2 if first else 1)
            return out
        finally:
            state.calling_model = outer

    def _first_program(self):
        """Whether the JAX package would initialize this model (lazily, at
        its first traced use) in the program about to be counted."""
        first, self._program_ticked = not self._program_ticked, True
        return first

    def backward(self, loss, num_tokens=None):
        """Mark the scalar to differentiate for this microbatch; the step
        engine differentiates it when the step function returns.

        ``num_tokens``: under context parallelism, the number of tokens this
        rank's ``loss`` averages over, when it is a mean over a token mask
        (its denominator); the step then weighs the ranks' losses and
        gradients by these counts, as the global masked mean does. None:
        the ranks weigh equally (a plain mean over equal shards). Ignored
        without context parallelism."""
        if self._bound is None:
            raise StepUsageError("model.backward() must be called inside an @smp.step function.")
        if self._backward_loss is not None:
            raise StepUsageError("model.backward() called twice in one microbatch.")
        self._backward_loss = loss
        self._num_tokens = num_tokens
        return loss

    # -- step-engine hooks ----------------------------------------------

    def _begin_microbatch(self, bound, rngs=None):
        self._bound = bound
        self._rngs = rngs
        self._layer_keys = {}
        self._backward_loss = None
        self._num_tokens = None
        self._moe_aux = []

    def _end_microbatch(self):
        """(the marked loss, its ``num_tokens``, the loss to differentiate).

        The last is the marked loss plus, when the microbatch's model calls
        recorded MoE load-balancing losses, their sum times the config's
        ``moe_aux_loss_weight`` (0 leaves it out), as the JAX package's
        ``_end_step_trace`` folds them; the step returns the marked loss."""
        loss, num_tokens, aux = self._backward_loss, self._num_tokens, self._moe_aux
        self._bound = None
        self._rngs = None
        self._backward_loss = None
        self._num_tokens = None
        self._moe_aux = []
        differentiated = loss
        weight = float(getattr(state.cfg, "moe_aux_loss_weight", 1.0))
        self._aux_term = None
        if loss is not None and aux and weight:
            total = sum(aux[1:], aux[0])
            self._aux_term = torch.full((), weight, dtype=loss.dtype, device=loss.device) * total.to(loss.dtype)
            differentiated = loss + self._aux_term
        return loss, num_tokens, differentiated

    def _sow_moe_aux(self, aux):
        """Record a ``DistributedMoE``'s load-balancing loss of this
        microbatch: inside a step only, and not from a checkpointed region's
        recompute (which replays its forward's keys), so each layer's loss
        counts once."""
        if self._bound is not None and self._key_replay is None:
            self._moe_aux.append(aux)

    def make_rng(self, module, name="dropout", child=None):
        """The key flax's ``make_rng(name)`` gives ``module`` (or its child
        scope ``child``) in this call: the microbatch's ``name`` key, split
        per layer inside a layer stack (flax's ``nn.scan(split_rngs=...)``:
        layer i takes ``split(key, L)[i]``, which is ``fold_in(key, i)``,
        derived once a microbatch), then folded with the scope's path and its
        per-call counter (``fold_in_static``). flax's ``nn.scan`` traces its
        body twice and the scopes inside keep their counters from the first
        trace, so a scanned scope that draws once a layer draws with counter
        2. flax's lifted remat (``nn.remat`` inside that ``nn.scan``) derives
        the same keys, so a checkpointed layer draws these too. Raises where
        flax finds no such key: outside an ``@smp.step``.

        In a checkpointed region's recompute (``replaying_keys``) the keys of
        its forward come back in order instead; the forward recorded them
        (``recording_keys``)."""
        if self._key_replay is not None:
            key = next(self._key_replay)
        else:
            if state.rdp_sharded:
                topo = state.topology
                raise NotImplementedError(
                    f"{type(module).__name__} draws a {name!r} key inside a data-parallel step (rdp = "
                    f"{topo.rdp_size}, expert_parallel_degree = {topo.ep_size}): each rank would have to draw its "
                    "rows' part of the global mask at its row offset, which is not ported to PyTorch yet (ROADMAP "
                    "Queue 1 item 6)."
                )
            key = self._derive_key(module, name, child)
        for tape in self._key_tapes:
            tape.append(key)
        return key

    def _derive_key(self, module, name, child):
        if self._rngs is None or name not in self._rngs:
            raise SMPValidationError(
                f"{type(module).__name__} needs PRNG for {name!r}: a module draws its {name} key inside an "
                "@smp.step (call the model in eval mode, or set the rate to 0, to run without it)."
            )
        scope = self._rng_scopes.get(module)
        if scope is None:
            raise SMPValidationError(f"{type(module).__name__} is not a submodule of the DistributedModel's module.")
        path, layer = scope
        if child is not None:
            path = path + (child,)
        count = self._rng_counts.get((layer, path), 0) + 1
        self._rng_counts[(layer, path)] = count
        key = self._rngs[name]
        if layer is not None:
            key = self._layer_keys.get((name, layer))
            if key is None:
                key = self._layer_keys[(name, layer)] = random.fold_in(self._rngs[name], layer)
            count += _SCAN_TRACES - 1
        return random.fold_in_static(key, path + (count,))

    @contextlib.contextmanager
    def recording_keys(self, tape):
        """Append every key ``make_rng`` gives inside the block to ``tape``."""
        self._key_tapes.append(tape)
        try:
            yield
        finally:
            self._key_tapes.remove(tape)

    @contextlib.contextmanager
    def replaying_keys(self, tape):
        """``make_rng`` gives ``tape``'s keys in order inside the block."""
        outer, self._key_replay = self._key_replay, iter(tape)
        try:
            yield
        finally:
            self._key_replay = outer

    # -- parameters and gradients ----------------------------------------

    @property
    def grads(self):
        """``{name: grad}`` of the last training step (microbatch mean, in
        the parameters' dtype), until ``optimizer.step()`` consumes it."""
        return self._grads

    def parameters(self):
        return list(self.module.parameters())

    def named_parameters(self):
        return list(self.module.named_parameters())

    def num_parameters(self):
        return sum(p.numel() for p in self.module.parameters())

    def register_post_partition_hook(self, hook):
        """Run ``hook(model)`` once, after the parameters exist and any
        deferred checkpoint state has been applied. Both happen when the
        model is built (the port has no partitioning pass to wait for), so
        the hook runs now."""
        hook(self)
        return hook

    def state_dict(self):
        """torch's ``state_dict`` of the module."""
        return self.module.state_dict()

    def reference_state_dict(self):
        """Host copy of the parameters in the JAX package's layout: a flat
        '/'-keyed dict of numpy arrays (the ``model`` entry of a full
        checkpoint)."""
        return self._to_reference(self.module.state_dict())

    def local_state_dict(self):
        """This rank's shard payload of ``reference_state_dict()``
        (``"key|bounds"`` entries, every leaf whole), round-trippable
        through ``load_state_dict``."""
        from smdistributed_modelparallel_tpu_torch.shard_io import shard_payload

        return shard_payload(self.reference_state_dict(), dedupe_global=False)

    def load_state_dict(self, state_dict):
        """Load torch's ``state_dict``, a reference-keyed flat dict
        (``reference_state_dict``, the JAX package's ``state_dict()``) or a
        shard payload (``local_state_dict``). As in the JAX package, only
        the entries the module has are taken (a translator's ``lm_head``
        entries for a model whose head is tied to its embedding are not),
        and an entry the module has but the dict lacks raises."""
        from smdistributed_modelparallel_tpu_torch.shard_io import InMemoryCatalog, is_shard_payload

        if is_shard_payload(state_dict):
            self.load_sharded(InMemoryCatalog(state_dict))
            return
        if state_dict and not set(state_dict) & set(self.module.state_dict()):
            state_dict = self._from_reference(state_dict)
        self._load_own(state_dict)

    def _load_own(self, state_dict):
        """Load the module's own entries of a torch-named dict (whole tensors
        of tp-sharded parameters are cut to this rank's part)."""
        own = self.module.state_dict()
        missing = [k for k in own if k not in state_dict]
        if missing:
            raise SMPValidationError(f"Missing parameter '{missing[0]}' in state dict.")
        self.module.load_state_dict(self._localize({k: state_dict[k] for k in own}))
        self._param_version += 1

    # -- tensor parallelism ----------------------------------------------

    def _localize(self, sd):
        """``sd`` with each whole tensor of a tp-sharded parameter cut to
        this rank's part (tensors already cut pass as they are)."""
        if not self._tp_specs:
            return sd
        shapes = {n: p.shape for n, p in self.module.named_parameters()}
        return convert.tp_shard(sd, self._tp_specs, tp_rank(), tp_group().size, shapes)

    def _gather_tp(self, sd):
        """``sd`` (torch names) with every tp-sharded tensor gathered whole:
        a collective over the tp group."""
        group = tp_group()
        return {k: (self._tp_specs[k].gather(v.detach(), group) if k in self._tp_specs else v) for k, v in sd.items()}

    def _tp_layout(self, to_ref, from_ref):
        """The reference maps at tp > 1: whole tensors in the reference
        layout both ways."""
        return (lambda sd: to_ref(self._gather_tp(sd))), (lambda flat: self._localize(from_ref(flat)))

    def tp_pieces(self):
        """``{reference key: [[start, stop], ...]}``: the region of each
        tp-sharded leaf of ``reference_state_dict()`` that this tp rank holds
        (empty at tp = 1). Found by mapping a tensor that holds each element's
        owning rank through the reference layout, once."""
        if self._tp_pieces is None:
            import numpy as np

            tp, me = tp_group().size if self._tp_specs else 1, tp_rank()
            params = dict(self.module.named_parameters())
            owners = {}
            for name, spec in self._tp_specs.items():
                full = torch.empty(spec.full_shape(params[name].shape), dtype=torch.int8)
                view = spec._view(full)
                for r, (lo, hi) in enumerate(spec.parts(tp)):
                    view.narrow(spec.dim + 1, lo, hi - lo).fill_(r)
                owners[name] = full
            to_ref = _reference_layout(self.module)[0]
            pieces = {}
            for key, owner in (to_ref(owners) if owners else {}).items():
                hit = np.nonzero(np.asarray(owner) == me)
                bounds = [[int(ax.min()), int(ax.max()) + 1] for ax in hit]
                if int(np.prod([b - a for a, b in bounds])) != len(hit[0]):
                    raise SMPRuntimeError(f"tp rank {me}'s part of {key!r} is not one rectangular region.")
                pieces[key] = bounds
            self._tp_pieces = pieces
        return self._tp_pieces

    def _note_sequence_parallel(self):
        """A layer stack ran its residual stream sharded along T inside
        this step (``optimize: "memory"``)."""
        if self._bound is not None:
            self._seq_parallel_ran = True

    def load_sharded(self, catalog):
        """Load a ``shard_io`` catalog: each leaf of the reference layout is
        assembled whole from the pieces that cover it (a checkpoint the JAX
        package wrote at tp or pp > 1 splits them), moved to the device and
        mapped to the module's names there."""
        try:
            loaded = catalog.load_tree(device=self.device)
        finally:
            catalog.close()
        self._load_own(self._from_reference(loaded))

    def generate(self, input_ids, max_new_tokens, **kwargs):
        """Autoregressive sampling through the KV-cache decode path; see
        ``smp.generate`` (``generation.py``)."""
        from smdistributed_modelparallel_tpu_torch.generation import generate

        return generate(self, input_ids, max_new_tokens, **kwargs)

    def train(self):
        self.module.train()
        return self

    def eval(self):
        self.module.eval()
        return self

    @property
    def training(self):
        return self.module.training


# flax's nn.scan traces its body twice; its scopes keep their rng counters
# from the first trace (make_rng).
_SCAN_TRACES = 2


def replay_program_ticks(notes, passes):
    """Tick each dispatch decision ``collect_program_ticks`` noted as the
    JAX package's traces of one program do: ``passes(kind, phase)`` traced
    passes, each ``_SCAN_TRACES`` ticks for a note made in a layer stack (a
    flax ``nn.scan``) and one outside a stack."""
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
        record_fused_kernel_dispatch,
        record_quant_dispatch,
    )

    for kind, label, path, stack, phase, _call in notes:
        record = record_fused_kernel_dispatch if kind == "fused" else record_quant_dispatch
        for _ in range(passes(kind, phase) * (_SCAN_TRACES if stack is not None else 1)):
            record(label, path)


def _rng_scopes(root):
    """``{module: (flax scope path, layer index or None)}`` for every module
    under ``root``: the torch attribute names, except that an entry i of a
    layer stack (a ``ModuleList`` of a module that names its flax scan body
    in ``_flax_scan_body``) is that body ("layer", "block") at layer i."""
    scopes = {}

    def walk(mod, path, layer):
        scopes[mod] = (path, layer)
        body = getattr(mod, "_flax_scan_body", None)
        for name, child in mod.named_children():
            if body is not None and isinstance(child, torch.nn.ModuleList):
                for i, sub in enumerate(child):
                    walk(sub, path + (name, body), i)
            else:
                walk(child, path + (name,), layer)

    walk(root, (), None)
    return scopes


def _shard_experts(module):
    """At ep > 1, keep the ep rank's experts in every ``DistributedMoE`` of
    ``module``; return the names of the parameters sliced so (empty at ep =
    1, where the experts are replicated like every other parameter)."""
    from smdistributed_modelparallel_tpu_torch.nn.moe import DistributedMoE

    topo = state.topology
    if topo is None or topo.ep_size == 1:
        return frozenset()
    index = topo.coords(state.rank)[EP_AXIS]
    names = set()
    for path, mod in module.named_modules():
        if isinstance(mod, DistributedMoE):
            mod.shard_experts(topo.ep_size, index)
            names.update(f"{path}.{n}" if path else n for n in mod.expert_parameter_names())
    return frozenset(names)


def _stack_replicated(module, specs):
    """The names of the replicated (not tp-sharded) parameters of every
    ``DistributedTransformer`` layer stack under ``module``: what sees this
    rank's tokens only when the stack runs sequence-parallel."""
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformer

    names = set()
    for path, mod in module.named_modules():
        if isinstance(mod, DistributedTransformer):
            names.update(n for n in (f"{path}.{p}" if path else p for p, _ in mod.named_parameters())
                         if n not in specs)
    return frozenset(names)


def _reference_layout(module):
    """``(to_reference, from_reference)``: the maps between the module's
    ``state_dict`` names and the JAX package's flat keys for the same
    model (``convert.jax_layout``). A module the JAX package has no
    counterpart for keeps its torch names."""
    layout = convert.jax_layout(module)
    if layout is not None:
        return layout
    return (lambda sd: {k: convert.to_numpy(v, copy=True) for k, v in sd.items()},
            lambda flat: {k: convert.to_torch(v) for k, v in flat.items()})
