"""PyTorch/CUDA port of ``smdistributed_modelparallel_tpu`` (``smp``).

The JAX package stays the reference; this package grows beside it slice by
slice, keeping its public names. It serves (``smp.generate``) and trains
(``@smp.step``, ``smp.DistributedOptimizer``) the ``TransformerLM`` zoo
(``models.gpt2``) on one device, with flash attention and the fused LM-head
cross-entropy as hand-written CUDA kernels for Hopper (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/fused_ce.cu``), and the ``smp.nn`` transformer
family at tp = 1, whose fused QKV and bias-GELU are kernels too
(``csrc/matmul_bias.cu``, ``csrc/bias_gelu.cu``) and which trains under
``matmul_precision: fp8`` with delayed scaling (``quant``; the fused QKV's
fp8 product is ``csrc/matmul_fp8.cu``). Under ``context_parallel_degree`` > 1
it trains with one process per rank (``torch.distributed``, from the launcher
variables), each on its sequence shard, through the ring (whose per-step
flash calls are the kernels' ids mode) or Ulysses. Entry points run on
``cuda`` unless the caller names another device.

It saves and resumes training runs in the JAX package's on-disk format
(``smp.save_checkpoint``, ``smp.resume_from_checkpoint``, ``smp.save`` /
``smp.load``; ``checkpoint.py``), so a run moves between the two packages in
either direction: the model's tensors in the JAX package's keys and layout,
``torch.optim.AdamW`` / ``torch.optim.Adam`` state as ``optax.adamw`` /
``optax.adam`` state (``optimizer.py``). ``smp.dataloader`` feeds the step
with batches staged on the device ahead of it (``utils/data.py``).

    import torch
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m

    smp.init({"microbatches": 4, "bf16": True})
    model = smp.DistributedModel(gpt2_124m())
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids, targets):
        loss = model(ids, targets=targets).mean()
        model.backward(loss)
        return loss

    for ids, targets in smp.dataloader(batches):
        loss = train_step(model, ids, targets).reduce_mean()
        optimizer.step()
    smp.save_checkpoint("/path/to/ckpt", partial=True, user_content={"epoch": 1})
    out = smp.generate(model, prompt_ids, max_new_tokens=32)

    # Resume, in this package or the JAX one: smp.init, then
    # smp.resume_from_checkpoint("/path/to/ckpt") before or after the model
    # and optimizer are built.
"""

from smdistributed_modelparallel_tpu_torch import amp, nn, quant
from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
from smdistributed_modelparallel_tpu_torch.backend.split import StepOutput
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
from smdistributed_modelparallel_tpu_torch.checkpoint import (
    load,
    resume_from_checkpoint,
    save,
    save_checkpoint,
    wait_for_checkpoints,
)
from smdistributed_modelparallel_tpu_torch.generation import generate
from smdistributed_modelparallel_tpu_torch.model import DistributedModel
from smdistributed_modelparallel_tpu_torch.optimizer import DistributedOptimizer
from smdistributed_modelparallel_tpu_torch.step import step
from smdistributed_modelparallel_tpu_torch.utils.data import dataloader, prefetch_to_device, shard_batches
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPRuntimeError,
    SMPValidationError,
    StepUsageError,
)


def init(config=None, device=None):
    """Validate ``config`` (a dict or ``ModelParallelConfig``) and start the
    framework on ``device``. None: under a launcher (``WORLD_SIZE`` or
    ``LOCAL_RANK`` set) ``cuda:LOCAL_RANK``, else ``cuda``, resolved when a
    model is placed. A world of more than one rank starts
    ``torch.distributed`` from the launcher variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); see
    ``backend/state.py``."""
    cfg = config if isinstance(config, ModelParallelConfig) else ModelParallelConfig(config)
    state.initialize(cfg, device=device)
    return cfg


def is_initialized():
    return state.initialized


def rank():
    """This process's global rank (one device per rank)."""
    state.check()
    return state.rank


def size():
    """The number of devices of the topology (the world, or
    ``_device_count_override``)."""
    state.check()
    return state.topology.size


def local_rank():
    """This process's rank on its host (``LOCAL_RANK``)."""
    state.check()
    return state.local_rank


def cp_rank():
    """This rank's coordinate on the context-parallel axis."""
    state.check()
    return state.topology.cp_rank(state.rank)


def cp_size():
    state.check()
    return state.topology.cp_size


def get_cp_group():
    """The global ranks of this rank's context-parallel group, in axis
    order."""
    state.check()
    return state.topology.axis_group(state.rank, CP_AXIS)


def reset():
    """Drop the config, device, model, optimizer, loss scaler, quant
    state, step count and any checkpoint state waiting to be applied."""
    state.reset()


__all__ = [
    "DistributedModel",
    "DistributedOptimizer",
    "ModelParallelConfig",
    "SMPRuntimeError",
    "SMPValidationError",
    "StepOutput",
    "StepUsageError",
    "amp",
    "cp_rank",
    "cp_size",
    "dataloader",
    "generate",
    "get_cp_group",
    "init",
    "is_initialized",
    "load",
    "local_rank",
    "nn",
    "prefetch_to_device",
    "quant",
    "rank",
    "reset",
    "resume_from_checkpoint",
    "save",
    "save_checkpoint",
    "shard_batches",
    "size",
    "step",
    "wait_for_checkpoints",
]
