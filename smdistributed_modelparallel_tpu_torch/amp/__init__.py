"""AMP-style grad scaler.

Counterpart of ``smdistributed_modelparallel_tpu/amp/__init__.py``: the
``torch.cuda.amp.GradScaler``-shaped surface (scale / step / update) over
the framework's ``DynamicLossScaler``. The step engine scales the loss,
unscales the gradients and checks them for overflow itself;
``DistributedOptimizer.step`` consults that check.
"""

from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler


class GradScaler(DynamicLossScaler):
    """torch.cuda.amp.GradScaler-shaped surface over DynamicLossScaler."""

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000, enabled=True):
        super().__init__(
            init_scale=init_scale,
            scale_factor=growth_factor,
            scale_window=growth_interval,
            backoff_factor=backoff_factor,
        )
        self.enabled = enabled

    def scale(self, loss):
        return loss * self.loss_scale if self.enabled else loss

    def get_scale(self):
        return self.loss_scale

    def step(self, optimizer):
        # DistributedOptimizer.step already consults the step's finite flag.
        optimizer.step()

    def unscale_(self, optimizer):
        # The step engine unscales the gradients; kept for API parity.
        pass


__all__ = ["GradScaler"]
