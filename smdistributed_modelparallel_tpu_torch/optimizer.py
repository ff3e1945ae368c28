"""``smp.DistributedOptimizer`` of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/optimizer.py`` on one
device. The JAX package wraps an ``optax.GradientTransformation``; this
package wraps a ``torch.optim.Optimizer`` built over the model's (fp32
master) parameters, as the reference SMP wraps torch optimizers.
``step()`` consumes the gradients that the last ``@smp.step`` call left on
the model: it clips them by their global norm when ``grad_clip_norm`` is
set (optax's formula), skips the update and backs the loss scale off when
an fp16 step overflowed, and otherwise installs them as ``.grad`` and runs
the wrapped optimizer.

Parity note: ``optax.adamw`` defaults to ``weight_decay=1e-4`` and
``torch.optim.AdamW`` to ``1e-2``; pass ``weight_decay=1e-4, eps=1e-8`` to
train as the JAX package's ``optax.adamw(lr)`` does.
"""

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPValidationError,
    StepUsageError,
)


class DistributedOptimizer:
    """Args:
      optimizer: a ``torch.optim.Optimizer`` over ``model.parameters()``.
      model: the ``DistributedModel`` (default: the last one created).
      grad_clip_norm: clip the gradients to this global L2 norm.
    """

    def __init__(self, optimizer, model=None, grad_clip_norm=None):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise SMPValidationError(
                "DistributedOptimizer expects a torch.optim.Optimizer "
                f"(got {type(optimizer).__name__})."
            )
        self.optimizer = optimizer
        self.model = model if model is not None else state.model
        if self.model is None:
            raise SMPValidationError("Create smp.DistributedModel before the optimizer.")
        self.grad_clip_norm = grad_clip_norm
        state.optimizer = self

    def step(self):
        """Apply the gradients of the last ``@smp.step`` call."""
        model = self.model
        grads = model._grads
        if grads is None:
            raise StepUsageError(
                "No gradients available: run an @smp.step function with "
                "model.backward(loss) before optimizer.step()."
            )
        model._dropped_updates = 0  # the loop does call optimizer.step()
        scaler = state.loss_scaler
        finite = model._grads_finite
        model._grads = None
        model._grads_finite = None
        if finite is not None and not finite:
            # Overflow under fp16 loss scaling: skip the update and back the
            # scale off.
            if scaler is not None:
                scaler.update(True)
            return
        if self.grad_clip_norm is not None:
            gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-6), max=1.0)
            grads = {n: g * scale.to(g.dtype) for n, g in grads.items()}
        params = dict(model.module.named_parameters())
        for name, g in grads.items():
            params[name].grad = g
        self.optimizer.step()
        for name in grads:
            params[name].grad = None
        model._param_version += 1
        if scaler is not None:
            scaler.update(False)

    def zero_grad(self):
        self.model._grads = None
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)
