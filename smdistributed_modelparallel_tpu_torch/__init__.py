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
flash calls are the kernels' ids mode) or Ulysses; under data parallelism
(rdp > 1) each rank trains a replica on its own rows and the step sums the
gradients over the rdp group. At world > 1 ``smp.init`` also brings up the
native host bus (the JAX package's ``native/src`` built into ``_build/``),
over which the control plane runs: ``smp.send``/``recv_from``,
``broadcast``, ``allgather``, the barriers, preemption across ranks and the
recovery supervisor's in-process reform (``backend/``). Entry points run on
``cuda`` unless the caller names another device.

It saves and resumes training runs in the JAX package's on-disk format
(``smp.save_checkpoint``, ``smp.resume_from_checkpoint``, ``smp.save`` /
``smp.load``; ``checkpoint.py``), so a run moves between the two packages in
either direction: the model's tensors in the JAX package's keys and layout,
``torch.optim.AdamW`` / ``torch.optim.Adam`` state as ``optax.adamw`` /
``optax.adam`` state (``optimizer.py``). ``smp.dataloader`` feeds the step
with batches staged on the device ahead of it (``utils/data.py``).
Activation checkpointing trades compute for memory: the smp.nn stack
recomputes each layer in the backward (``DistributedTransformerLMHead(
activation_checkpointing=True)``, or ``smp.set_activation_checkpointing``
before the model is built; ``smp.checkpoint`` and
``smp.checkpoint_sequential`` for any function), keeping what the
``recompute`` config asks for, or sending the layer inputs to pinned host
memory under ``offload_activations`` (``parallel/memory.py``).
``smp.serving.ServingEngine`` serves a stream of ragged requests from the
zoo by continuous batching over a paged KV cache (``serving/``).
``smp.from_hf`` takes a HuggingFace GPT-2, GPT-J, GPT-Neo, GPT-NeoX, BERT,
RoBERTa or ViT model (or any object with its ``config`` and ``state_dict()``;
``transformers`` is optional) onto the ``smp.nn`` modules, and its full
checkpoints save back to HF names (``nn/huggingface``). Modules built inside
``smp.tensor_parallelism()`` (or marked by ``smp.set_tensor_parallelism``)
are swapped for their registered ``smp.nn`` counterparts when the
``DistributedModel`` is built (``nn/auto_distribute.py``, ``smp.tp_register``);
at tp = 1 they compute what the originals do.

Observability, as in the JAX package (``utils/``): ``smp.telemetry`` (the
metrics registry: ``report()``, ``render_prometheus()``, the JSON dump to
``SMP_TELEMETRY_PATH``), ``smp.watchdog``, ``smp.flight_recorder``,
``smp.goodput`` (wall-clock attribution), ``smp.profiling`` (named regions,
``SMP_PROFILE`` capture with ``torch.profiler``, the roofline), the session
timeline (``SMP_TIMELINE_PATH``), the serving time series
(``SMP_TIMESERIES_INTERVAL``), ``smp.fleet`` (the fleet metrics plane and its
scrape endpoint, ``SMP_FLEET_INTERVAL``), and ``smp.shutdown()``, which
writes the dumps. Resilience: ``smp.health`` (the numerics sentinel,
``SMP_HEALTH_CHECK``, whose reduction is the ``csrc/health_reduce.cu`` kernel,
and the OOM post-mortem), ``smp.resilience`` (preemption's emergency
checkpoint on SIGTERM or ``SMP_PREEMPTION_FILE``, the ``SMP_CHAOS`` fault
injector) and ``smp.supervisor`` (``SMP_SUPERVISOR``; at one rank it arms no
detector).

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

    # An HF model: train it, save it back to HF names.
    model = smp.from_hf(hf_model, fused_bias_gelu=True)
    smp.save_checkpoint("/path/to/ckpt", partial=False)  # its "model" dict loads into hf_model
"""

from contextlib import contextmanager

import torch

from smdistributed_modelparallel_tpu_torch import amp, nn, quant, serving
from smdistributed_modelparallel_tpu_torch.backend import core
from smdistributed_modelparallel_tpu_torch.backend.collectives import CollectiveCommunicator, CommGroup, RankType
from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
from smdistributed_modelparallel_tpu_torch.backend.split import StepOutput, TensorSplitter
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.checkpoint import (
    load,
    resume_from_checkpoint,
    save,
    save_checkpoint,
    wait_for_checkpoints,
)
from smdistributed_modelparallel_tpu_torch.generation import generate
from smdistributed_modelparallel_tpu_torch.model import DistributedModel
from smdistributed_modelparallel_tpu_torch.nn.huggingface import from_hf
from smdistributed_modelparallel_tpu_torch.nn.tp_registry import tp_register, tp_register_with_module
from smdistributed_modelparallel_tpu_torch.optimizer import DistributedOptimizer
from smdistributed_modelparallel_tpu_torch.step import step
from smdistributed_modelparallel_tpu_torch import resilience
from smdistributed_modelparallel_tpu_torch.resilience.supervisor import supervisor
from smdistributed_modelparallel_tpu_torch.utils import health, profiling
from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet
from smdistributed_modelparallel_tpu_torch.utils.data import dataloader, prefetch_to_device, shard_batches
from smdistributed_modelparallel_tpu_torch.utils import exceptions
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    NotInitializedError,
    SMPError,
    SMPRuntimeError,
    SMPUnsupportedError,
    SMPValidationError,
    StepUsageError,
)
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry, watchdog

logger = get_logger()

WORLD = CommGroup.WORLD
PP_GROUP = CommGroup.PP_GROUP
TP_GROUP = CommGroup.TP_GROUP
DP_GROUP = CommGroup.DP_GROUP
RDP_GROUP = CommGroup.RDP_GROUP
MP_GROUP = CommGroup.MP_GROUP


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


# -- rank, size and group queries (backend/core.py) ----------------------
# One process a device: each answers for this process.

def rank():
    """This process's global rank (one device per rank)."""
    return core.rank()


def size():
    """The number of devices of the topology (the world, or
    ``_device_count_override``)."""
    return core.size()


def local_rank():
    """This process's rank on its host (``LOCAL_RANK``)."""
    return core.local_rank()


def local_size():
    """The number of ranks on this process's host."""
    return core.local_size()


def pp_rank():
    return core.pp_rank()


def tp_rank():
    return core.tp_rank()


def rdp_rank():
    return core.rdp_rank()


def dp_rank():
    return core.dp_rank()


def mp_rank():
    return core.mp_rank()


def cp_rank():
    """This rank's coordinate on the context-parallel axis."""
    return core.cp_rank()


def pp_size():
    return core.pp_size()


def tp_size():
    return core.tp_size()


def rdp_size():
    """The reference's D dimension: rdp x cp x ep."""
    return core.rdp_size()


def dp_size():
    return core.dp_size()


def mp_size():
    return core.mp_size()


def cp_size():
    return core.cp_size()


def num_microbatches():
    return state.cfg.microbatches if state.cfg else 1


def get_pp_group():
    return core.get_pp_group()


def get_tp_group():
    return core.get_tp_group()


def get_dp_group():
    return core.get_dp_group()


def get_rdp_group():
    return core.get_rdp_group()


def get_mp_group():
    return core.get_mp_group()


def get_cp_group():
    """The global ranks of this rank's context-parallel group, in axis
    order."""
    return core.get_cp_group()


def get_world_group():
    return core.get_world_group()


# The reference's names for the same groups.
get_pp_process_group = get_pp_group
get_tp_process_group = get_tp_group
get_dp_process_group = get_dp_group
get_rdp_process_group = get_rdp_group
get_mp_process_group = get_mp_group
get_world_process_group = get_world_group


def get_mesh():
    """The rank grid of the topology (``DeviceMesh``): ``dict(get_mesh().shape)``
    is the JAX package's ``{axis: size}`` of its mesh."""
    state.check()
    return state.topology.mesh


def pp_rank_to_rank(pp_rank):
    """World rank of pipeline stage ``pp_rank`` in this rank's tp x rdp
    coordinates."""
    return core.pp_rank_to_rank(pp_rank)


def tp_rank_to_rank(tp_rank):
    return core.tp_rank_to_rank(tp_rank)


def rdp_rank_to_rank(rdp_rank):
    return core.rdp_rank_to_rank(rdp_rank)


def dp_rank_to_rank(dp_rank):
    return core.dp_rank_to_rank(dp_rank)


def mp_rank_to_rank(mp_rank):
    return core.mp_rank_to_rank(mp_rank)


def process_index():
    """This process's index (its rank: one process a device)."""
    state.check()
    return state.rank


def process_count():
    state.check()
    return state.world_size


def instance_id(rank=None):
    """The host of device ``rank`` (default: this process's)."""
    return core.instance_id(rank)


def is_in_same_instance(rank):
    """Whether device ``rank`` is on this process's host."""
    return core.is_in_same_instance(rank)


def is_multi_node():
    return core.is_multi_node()


def is_tracing():
    """True inside the JAX package's first-step trace pass. The port runs
    its steps eagerly and has no such pass: always False."""
    return False


# -- the host control plane (backend/collectives.py, over the native bus) --

def barrier(group=CommGroup.WORLD):
    """Barrier over the processes of ``group``."""
    state.comm.barrier(group=group)


def mp_barrier():
    barrier(CommGroup.MP_GROUP)


def pp_barrier():
    barrier(CommGroup.PP_GROUP)


def dp_barrier():
    barrier(CommGroup.DP_GROUP)


def tp_barrier():
    barrier(CommGroup.TP_GROUP)


def rdp_barrier():
    barrier(CommGroup.RDP_GROUP)


def broadcast(obj, group=CommGroup.WORLD, src=0):
    """Member ``src``'s picklable ``obj`` on every process of ``group``."""
    return state.comm.broadcast(obj, group=group, src=src)


def allgather(obj, group=CommGroup.WORLD):
    """Every process of ``group``'s picklable ``obj``, in group order."""
    return state.comm.allgather(obj, group=group)


def send(obj, dest, group=CommGroup.WORLD):
    """Send a picklable object to process ``dest`` of ``group`` (queued;
    returns at once)."""
    state.comm.send(obj, dest, group=group)


def recv_from(src, group=CommGroup.WORLD):
    """The next object, in order, from process ``src`` of ``group``."""
    return state.comm.recv_from(src, group=group)


def shutdown():
    """End the session: decode the health sentinel's pending word, stop the
    goodput ledger and the fleet plane, close an open profiler capture,
    flush the timeline, dump the telemetry and the flight recorder (where
    their paths are set), then reset. Also runs at interpreter exit while
    the framework is initialized (without the reset)."""
    # Cheap mode decodes one step behind: a run whose final step went
    # non-finite still says so (utils/health.py).
    try:
        health.monitor.flush()
    except Exception as e:
        logger.warning("health monitor flush failed: %s", e)
    state.shutdown()
    state.reset()


def reset():
    """Drop the config, device, model, optimizer, loss scaler, quant
    state, step count, the module annotations (activation-checkpoint
    configs, tp marks, partitions), the tp registry and any checkpoint state
    waiting to be applied, and clear the telemetry registry, the flight
    recorder, the goodput ledger, the profiler capture and the generate
    program keys."""
    from smdistributed_modelparallel_tpu_torch.generation import _PROGRAMS

    _PROGRAMS.clear()
    state.reset()


def _module_manager():
    from smdistributed_modelparallel_tpu_torch.module_manager import ModuleManager

    if state.module_manager is None:
        state.module_manager = ModuleManager()
    return state.module_manager


def set_activation_checkpointing(module_prefix, **config):
    """Checkpoint the modules under ``module_prefix`` (a '/'-joined path of
    torch attribute names, e.g. ``"transformer"``; ``""`` or ``"main"`` the
    whole model): every module that has an ``activation_checkpointing`` flag
    and that the prefix touches (itself, an ancestor or a descendant) turns
    it on when the ``DistributedModel`` is built. Call it after
    ``smp.init``."""
    _module_manager().set_activation_checkpointing(module_prefix, **config)


def partition(stage):
    """Context: registered modules built inside are assigned to pipeline
    stage ``stage`` (recorded when the ``DistributedModel`` is built; at
    pp = 1 only stage 0 exists)."""
    return _module_manager().partition(stage)


def set_partition(module_prefix, stage):
    """Assign the modules under ``module_prefix`` to pipeline stage
    ``stage``."""
    _module_manager().set_partition(module_prefix, stage)


def get_partition(module_prefix):
    """The pipeline stage that runs ``module_prefix`` (a '/'-joined path)."""
    from smdistributed_modelparallel_tpu_torch.module_manager import _normalize_prefix

    if not isinstance(module_prefix, str):
        raise SMPValidationError(
            f"get_partition expects a '/'-joined module path string (got {type(module_prefix).__name__})."
        )
    return _module_manager().stage_of(_normalize_prefix(module_prefix))


def set_tensor_parallelism(module_prefix, enabled=True, **tp_config):
    """Mark (or, ``enabled=False``, unmark) the module at ``module_prefix``
    for distribution with ``tp_config``."""
    _module_manager().set_tensor_parallelism(module_prefix, enabled, **tp_config)


@contextmanager
def tensor_parallelism(enabled=True, **tp_config):
    """Context: registered modules built inside are marked for distribution
    with ``tp_config`` (``enabled=False`` leaves them unmarked), and swapped
    for their registered ``smp.nn`` counterparts when the
    ``DistributedModel`` is built."""
    from smdistributed_modelparallel_tpu_torch.nn.huggingface import register_predefined_hooks

    if state.tp_registry is not None:
        register_predefined_hooks(state.tp_registry)  # transformers may have been imported since smp.init
    mm = _module_manager()
    prev, mm._active_tp = mm._active_tp, {"enabled": enabled, **tp_config}
    try:
        yield
    finally:
        mm._active_tp = prev


@contextmanager
def delay_param_initialization(enabled=True):
    """Context: modules built inside create their parameters on the model's
    device (``smp.init``'s, else cuda), so no host copy of the full model is
    made; the JAX package gets the same by initializing lazily into the
    device shardings. ``enabled=False`` raises, as in the JAX package."""
    if not enabled:
        raise SMPUnsupportedError(
            "delay_param_initialization(enabled=False) is not supported: parameters are always created on "
            "the model's device."
        )
    from smdistributed_modelparallel_tpu_torch.model import resolve_device

    with resolve_device(None):
        yield


@contextmanager
def model_creation(tensor_parallelism=False, dtype=None, **tensor_parallel_config):
    """Context for building a model: ``tensor_parallelism`` marks the
    registered modules built inside (``smp.tensor_parallelism``), and their
    parameters are created on the device (``delay_param_initialization``).
    ``dtype`` must be float32 or the configured half dtype (the step casts
    the fp32 master parameters to it); a conflict raises."""
    if dtype is not None:
        # The live config only: after smp.reset() there is none to agree with.
        if not state.initialized:
            raise NotInitializedError("smp.model_creation(dtype=...)")
        half = state.cfg.half_dtype
        if dtype not in (torch.float32, half):
            raise SMPValidationError(
                f"model_creation(dtype={dtype}) conflicts with the configured compute dtype ({half or 'float32'}); "
                "set the bf16/fp16 config key instead of a per-model dtype."
            )
    # The parameter shadows the context of the same name (the reference's
    # signature names both).
    tp_ctx = globals()["tensor_parallelism"]
    with tp_ctx(enabled=tensor_parallelism, **tensor_parallel_config), delay_param_initialization():
        yield


# Bound after the ``checkpoint`` submodule's import above, so that
# ``smp.checkpoint`` is this function, as in the JAX package.
def checkpoint(fn, *args, **kwargs):
    """Run ``fn`` as a checkpointed region (``parallel/memory.checkpoint``):
    ``smp.checkpoint(fn)(args...)`` or ``smp.checkpoint(fn, args...)``."""
    from smdistributed_modelparallel_tpu_torch.parallel.memory import checkpoint as _checkpoint

    return _checkpoint(fn, *args, **kwargs)


def checkpoint_sequential(fns, input, strategy="each"):
    """Apply ``fns`` in turn, each one ("each") or each group of N
    ("group_N") a checkpointed region (``parallel/memory``)."""
    from smdistributed_modelparallel_tpu_torch.parallel.memory import checkpoint_sequential as _checkpoint_sequential

    return _checkpoint_sequential(fns, input, strategy)


__all__ = [
    "DistributedModel",
    "DistributedOptimizer",
    "ModelParallelConfig",
    "SMPRuntimeError",
    "SMPValidationError",
    "StepOutput",
    "StepUsageError",
    "amp",
    "checkpoint",
    "checkpoint_sequential",
    "cp_rank",
    "cp_size",
    "dataloader",
    "delay_param_initialization",
    "flight_recorder",
    "from_hf",
    "generate",
    "get_cp_group",
    "get_partition",
    "fleet",
    "goodput",
    "health",
    "init",
    "is_initialized",
    "load",
    "local_rank",
    "model_creation",
    "nn",
    "partition",
    "prefetch_to_device",
    "profiling",
    "quant",
    "rank",
    "reset",
    "resilience",
    "resume_from_checkpoint",
    "save",
    "save_checkpoint",
    "serving",
    "set_activation_checkpointing",
    "set_partition",
    "set_tensor_parallelism",
    "shard_batches",
    "shutdown",
    "size",
    "step",
    "supervisor",
    "telemetry",
    "tensor_parallelism",
    "tp_register",
    "tp_register_with_module",
    "wait_for_checkpoints",
    "watchdog",
]
