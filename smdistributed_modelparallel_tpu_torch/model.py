"""``smp.DistributedModel`` of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/model.py`` for one device:
it wraps a ``torch.nn.Module``, places it on its device and exposes
``module``, ``state_dict``/``load_state_dict``, ``generate`` and the
training surface: ``backward`` inside an ``@smp.step`` function, ``grads``
after it, ``parameters``/``num_parameters`` and ``train``/``eval``. Inside
a step, ``model(...)`` runs the module on the parameters the step engine
bound for the microbatch (half casts of the fp32 master parameters under
bf16/fp16), and ``model.backward(loss)`` marks the loss that the engine
differentiates. Pipeline and tensor parallelism arrive with later slices.

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

Activation checkpointing. A config registered with
``smp.set_activation_checkpointing`` before the model is built turns on the
``activation_checkpointing`` flag of every module it touches (the JAX
package's rule, ``_ckpt_config_touches``). A checkpointed region
(``parallel/memory``) records the keys ``make_rng`` gives in its forward and
replays them in its recompute, which runs in the step's backward after the
microbatch has ended.

Checkpoints. ``state_dict()`` is torch's own. The checkpoint files hold the
JAX package's layout instead, so that either package resumes the other's
runs: ``reference_state_dict()`` is the flat '/'-keyed dict of numpy arrays
that the JAX package's ``DistributedModel.state_dict()`` gives for the same
model (``convert.params_to_jax`` for the zoo's ``TransformerLM``,
``convert.lm_head_params_to_jax`` for ``smp.nn.DistributedTransformerLMHead``;
any other module keeps its torch names), and ``local_state_dict()`` the same
as a shard payload (``shard_io``). ``load_state_dict`` takes any of the three,
and ``load_sharded`` a ``shard_io`` catalog. A checkpoint that
``smp.resume_from_checkpoint`` read before the model existed is applied when
the model is built, before any ``register_post_partition_hook`` hook runs.
"""

import contextlib
import functools

import torch

from smdistributed_modelparallel_tpu_torch import convert
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
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
    """

    def __init__(self, module, device=None, rngs=("dropout",)):
        if state.cfg is None:
            raise SMPValidationError("Call smp.init(config) before DistributedModel().")
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.rng_streams = tuple(rngs)
        self._rngs = None           # {stream: key} of the current microbatch
        self._rng_counts = {}       # make_rng calls of this model call, by (layer, scope path)
        self._layer_keys = {}       # (stream, layer) -> the stream key split for that layer
        self._key_tapes = []        # keys drawn are appended to each (checkpointed regions' forwards)
        self._key_replay = None     # iterator of the keys a recompute draws instead
        self._rng_scopes = _rng_scopes(self.module)
        _apply_checkpoint_configs(self.module, state.module_manager)
        group = state.group(CP_AXIS)
        if group is not None:
            # Parameters are replicated over cp: every rank starts from the
            # group's first rank's.
            group.flat_(group.broadcast, [*self.module.parameters(), *self.module.buffers()])
        self._grads = None          # {name: grad} of the last training step
        self._grads_finite = None   # bool under fp16 loss scaling
        self._bound = None          # {name: tensor} bound for the current microbatch
        self._backward_loss = None
        self._param_version = 0     # bumped whenever the parameters change
        self._params_at_step = None
        self._dropped_updates = 0
        self._to_reference, self._from_reference = _reference_layout(self.module)
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
            return self.module(*args, **kwargs)
        finally:
            state.calling_model = outer

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

    def _end_microbatch(self):
        """(the marked loss, its ``num_tokens``)."""
        loss, num_tokens = self._backward_loss, self._num_tokens
        self._bound = None
        self._rngs = None
        self._backward_loss = None
        self._num_tokens = None
        return loss, num_tokens

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
        shard payload (``local_state_dict``)."""
        from smdistributed_modelparallel_tpu_torch.shard_io import InMemoryCatalog, is_shard_payload

        if is_shard_payload(state_dict):
            self.load_sharded(InMemoryCatalog(state_dict))
            return
        if state_dict and not set(state_dict) & set(self.module.state_dict()):
            state_dict = self._from_reference(state_dict)
        self.module.load_state_dict(state_dict)
        self._param_version += 1

    def load_sharded(self, catalog):
        """Load a ``shard_io`` catalog: each leaf of the reference layout is
        assembled whole from the pieces that cover it (a checkpoint the JAX
        package wrote at tp or pp > 1 splits them), moved to the device and
        mapped to the module's names there."""
        try:
            loaded = catalog.load_tree(device=self.device)
        finally:
            catalog.close()
        self.module.load_state_dict(self._from_reference(loaded))
        self._param_version += 1

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


def _apply_checkpoint_configs(root, mm):
    """Turn on ``activation_checkpointing`` of every module under ``root``
    that has the flag and that a config registered with
    ``smp.set_activation_checkpointing`` touches: its path (the torch
    attribute names joined by '/'), "" (every module), an ancestor or a
    descendant, as the JAX package's ``_ckpt_config_touches``. The root's
    path is "", so any config turns on the LM head's flag, which is its
    stack's, as the flax field reaches the stack."""
    if mm is None or not mm.checkpoint_configs:
        return
    for name, mod in root.named_modules():
        if hasattr(mod, "activation_checkpointing") and _ckpt_config_touches(mm, name.replace(".", "/")):
            mod.activation_checkpointing = True


def _ckpt_config_touches(mm, path):
    """True if any activation-checkpoint config targets ``path``, one of its
    ancestors, or one of its descendants."""
    for prefix in mm.checkpoint_configs:
        if (prefix == path or prefix == "" or path == "" or path.startswith(prefix + "/")
                or prefix.startswith(path + "/")):
            return True
    return False


def _reference_layout(module):
    """``(to_reference, from_reference)``: the maps between the module's
    ``state_dict`` names and the JAX package's flat keys for the same
    model. A module the JAX package has no counterpart for keeps its torch
    names."""
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.nn.transformer import (
        DistributedAttentionLayer,
        DistributedTransformerLMHead,
    )

    if isinstance(module, TransformerLM):
        return convert.params_to_jax, convert.params_from_jax
    if isinstance(module, DistributedTransformerLMHead):
        heads = [m.num_attention_heads for m in module.modules() if isinstance(m, DistributedAttentionLayer)]
        to_ref = functools.partial(convert.lm_head_params_to_jax, num_attention_heads=heads[0] if heads else 1)
        return to_ref, convert.lm_head_params_from_jax
    return (lambda sd: {k: convert.to_numpy(v, copy=True) for k, v in sd.items()},
            lambda flat: {k: convert.to_torch(v) for k, v in flat.items()})
