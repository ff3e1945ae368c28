"""``smp.DistributedModel`` of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/model.py`` for one device:
it wraps a ``torch.nn.Module``, places it on its device and exposes
``module``, ``state_dict``/``load_state_dict`` and ``generate``. Pipeline
and tensor parallelism arrive with later slices.
"""

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPRuntimeError,
    SMPValidationError,
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

    def __call__(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict):
        self.module.load_state_dict(state_dict)

    def generate(self, input_ids, max_new_tokens, **kwargs):
        """Autoregressive sampling through the KV-cache decode path; see
        ``smp.generate`` (``generation.py``)."""
        from smdistributed_modelparallel_tpu_torch.generation import generate

        return generate(self, input_ids, max_new_tokens, **kwargs)
