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

import functools

import torch

from smdistributed_modelparallel_tpu_torch import convert
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
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

    def __init__(self, module, device=None):
        if state.cfg is None:
            raise SMPValidationError("Call smp.init(config) before DistributedModel().")
        self.device = resolve_device(device)
        self.module = module.to(self.device)
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
        if self._bound is not None:
            return torch.func.functional_call(self.module, self._bound, args, kwargs)
        return self.module(*args, **kwargs)

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

    def _begin_microbatch(self, bound):
        self._bound = bound
        self._backward_loss = None
        self._num_tokens = None

    def _end_microbatch(self):
        """(the marked loss, its ``num_tokens``)."""
        loss, num_tokens = self._backward_loss, self._num_tokens
        self._bound = None
        self._backward_loss = None
        self._num_tokens = None
        return loss, num_tokens

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
