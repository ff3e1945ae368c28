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
"""

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPRuntimeError,
    SMPValidationError,
    StepUsageError,
)


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
        state.model = self

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

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict):
        self.module.load_state_dict(state_dict)
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
