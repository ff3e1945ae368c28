"""Process-wide framework state of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/backend/state.py``: the
resolved config, whether ``smp.init`` ran, the device, the current model
and optimizer, the fp16 loss scaler (a ``DynamicLossScaler`` when the config
asks for fp16, as in the JAX package) and the fp8 delayed-scaling state
(``quant.QuantState``, created by the first step under
``matmul_precision: fp8``).

Ranks. The JAX package runs one program over a device mesh; the port runs
one process per device. ``smp.init`` reads the usual launcher variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
without them the world is one process, as before. It builds the
``DeviceTopology`` (whose degree check refuses what the device count cannot
hold) and, for a world of more than one, starts ``torch.distributed`` (a gloo
default group at ``tcp://MASTER_ADDR:MASTER_PORT``) and creates one
``TensorGroup`` for every mesh axis of size > 1, its transport chosen once
from the members' devices (``backend/collectives.py``).

Device. An explicit ``smp.init(device=...)`` wins. Otherwise, under a
launcher (``LOCAL_RANK`` or ``WORLD_SIZE`` set), the device is
``cuda:LOCAL_RANK`` and ``smp.init`` refuses a ``LOCAL_RANK`` the card count
cannot hold; with no launcher it is left to the model (``cuda``).

Checkpoints. ``step_count`` counts the ``@smp.step`` calls since
``smp.init`` (the step edge a checkpoint records, and the default tag
``step_{n}``). ``loaded_model_state`` and ``loaded_optimizer_state`` hold
what ``smp.resume_from_checkpoint`` read before the model or the optimizer
existed; ``DistributedModel`` and ``DistributedOptimizer`` apply them when
they are built.

Random keys. ``rng_manager`` is the ``utils/random.RngManager`` of the
config's ``tensor_parallel_seed``, made by ``smp.init``; ``step_rng`` is the
key the next ``@smp.step`` splits (None until the first step draws it from
the "step" stream). ``smp.init`` and ``smp.reset`` clear both, as the JAX
package's re-initialization does. ``calling_model`` is the
``DistributedModel`` whose call is running: the one whose microbatch keys a
module's ``nn/utils.make_rng`` reads.

``cp_sharded`` is True while an ``@smp.step`` runs its microbatches on the
rank's contiguous sequence shard under context parallelism: attention then
runs the cp ring (or Ulysses) and positions are offset by the shard's start.
Outside a step (``smp.generate``, a bare model call) every rank holds whole
sequences and computes as at cp = 1.

``module_manager`` is the ``module_manager.ModuleManager`` that
``smp.set_activation_checkpointing`` fills (after ``smp.init``, before the
model is built); ``smp.init`` and ``smp.reset`` clear it.
"""

import os

from smdistributed_modelparallel_tpu_torch.utils.exceptions import NotInitializedError, SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.random import RngManager
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


def _env_int(name, default):
    value = os.environ.get(name, "").strip()
    return int(value) if value else default


def _launcher_device(local_rank):
    import torch

    count = torch.cuda.device_count()
    if local_rank >= count:
        raise SMPValidationError(
            f"LOCAL_RANK={local_rank} names cuda:{local_rank}, but this host has {count} CUDA "
            "device(s); pass smp.init(device=...) to place the rank yourself."
        )
    return f"cuda:{local_rank}"


class ModelParallelState:
    def __init__(self):
        self.reset()

    @property
    def initialized(self):
        return self.cfg is not None

    def initialize(self, cfg, device=None):
        from smdistributed_modelparallel_tpu_torch.backend.topology import DeviceTopology

        self.reset()
        launched = "WORLD_SIZE" in os.environ or "LOCAL_RANK" in os.environ
        world = _env_int("WORLD_SIZE", 1)
        rank = _env_int("RANK", 0)
        local_rank = _env_int("LOCAL_RANK", 0)
        topology = DeviceTopology(cfg, world)
        if not 0 <= rank < topology.size:
            raise SMPValidationError(f"RANK={rank} lies outside the {topology.size} device(s) of the topology.")
        if device is None and launched:
            device = _launcher_device(local_rank)
        self.cfg = cfg
        self.device = device
        self.world_size, self.rank, self.local_rank = world, rank, local_rank
        self.topology = topology
        self.rng_manager = RngManager(cfg.tensor_parallel_seed)
        if world > 1:
            self.groups = _build_groups(topology, world, rank, device)
        logger.info("Initialized %s over %d rank(s); this is rank %d.", topology, world, rank)
        if cfg.fp16:
            from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler

            self.loss_scaler = DynamicLossScaler()

    def reset(self):
        self.cfg = None
        self.device = None
        self.model = None
        self.calling_model = None  # the DistributedModel whose call is running
        self.optimizer = None
        self.loss_scaler = None
        self.quant_state = None
        self.step_count = 0
        self.rng_manager = None
        self.step_rng = None
        self.loaded_model_state = None
        self.loaded_optimizer_state = None
        self.world_size, self.rank, self.local_rank = 1, 0, 0
        self.topology = None
        self.groups = {}
        self.cp_sharded = False
        self.module_manager = None  # smp.set_activation_checkpointing's registry (module_manager.py)

    def check(self):
        if self.cfg is None:
            raise NotInitializedError()

    def group(self, axis):
        """This rank's ``TensorGroup`` along ``axis`` (None at size 1)."""
        return self.groups.get(axis)

    def sequence_offset(self, local_len):
        """Global position of the first token of this rank's sequence shard
        of ``local_len`` tokens: ``cp_rank * local_len`` inside a cp step,
        else 0."""
        if not self.cp_sharded:
            return 0
        return self.topology.cp_rank(self.rank) * local_len


def _build_groups(topology, world, rank, device):
    """Start ``torch.distributed`` (gloo) if the caller has not, and create
    every group of every mesh axis of size > 1 (all ranks create all groups,
    in one order); return ``{axis: this rank's TensorGroup}``."""
    import torch
    import torch.distributed as dist

    from smdistributed_modelparallel_tpu_torch.backend.collectives import (
        TensorGroup,
        choose_transport,
        device_key,
    )

    if not dist.is_initialized():
        port = os.environ.get("MASTER_PORT", "").strip()
        if not port:
            raise SMPValidationError("WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT to start torch.distributed.")
        addr = os.environ.get("MASTER_ADDR", "localhost").strip() or "localhost"
        dist.init_process_group("gloo", init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank)
    elif dist.get_world_size() != world or dist.get_rank() != rank:
        raise SMPValidationError(
            f"torch.distributed runs rank {dist.get_rank()} of {dist.get_world_size()}, but the launcher "
            f"variables say rank {rank} of {world}."
        )
    if device is not None and torch.device(device).type == "cuda" and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))  # NCCL works on the current device
    keys = [None] * world
    dist.all_gather_object(keys, device_key(device or "cuda"))
    groups = {}
    for axis, size in zip(topology.axis_names, topology.axis_sizes):
        if size == 1:
            continue
        for ranks in topology.axis_groups(axis):
            transport = choose_transport([keys[r] for r in ranks])
            pg = dist.new_group(ranks, backend=transport)
            if rank in ranks:
                groups[axis] = TensorGroup(ranks, pg, transport, rank, device)
                note = " (host copies of CUDA tensors)" if transport == "gloo" and keys[rank] != "cpu" else ""
                logger.info("%s group %s: transport %s%s", axis, ranks, transport, note)
    return groups


state = ModelParallelState()
