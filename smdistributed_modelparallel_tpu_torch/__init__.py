"""PyTorch/CUDA port of ``smdistributed_modelparallel_tpu`` (``smp``).

The JAX package stays the reference; this package grows beside it slice by
slice, keeping its public names. This slice serves: ``smp.init``,
``smp.DistributedModel`` and ``smp.generate`` on the ``TransformerLM`` zoo
(``models.gpt2``), with the flash-attention forward as a hand-written CUDA
kernel for Hopper (``csrc/flash_fwd.cu``). Entry points run on ``cuda``
unless the caller names another device.

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m

    smp.init({"bf16": True})
    model = smp.DistributedModel(gpt2_124m())
    out = smp.generate(model, prompt_ids, max_new_tokens=32)
"""

from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.generation import generate
from smdistributed_modelparallel_tpu_torch.model import DistributedModel


def init(config=None, device=None):
    """Validate ``config`` (a dict or ``ModelParallelConfig``) and start the
    framework on ``device`` (None: ``cuda``, resolved when a model is
    placed)."""
    cfg = config if isinstance(config, ModelParallelConfig) else ModelParallelConfig(config)
    state.initialize(cfg, device=device)
    return cfg


def is_initialized():
    return state.initialized


def reset():
    """Drop the config and device."""
    state.reset()


__all__ = [
    "DistributedModel",
    "ModelParallelConfig",
    "generate",
    "init",
    "is_initialized",
    "reset",
]
