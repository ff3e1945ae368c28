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
default group at ``tcp://MASTER_ADDR:MASTER_PORT``, whose timeout is
``SMP_COLLECTIVE_TIMEOUT`` when it is set, so that a collective with a dead
peer raises instead of waiting for ever), brings the native host bus up
(``comm``, the ``backend/collectives.CollectiveCommunicator``, under the
telemetry phase ``init/distributed``), gathers every rank's host name
(``hosts``) and creates one ``TensorGroup`` for every mesh axis of size > 1
(at rdp = 2, ``group("rdp")`` is the data-parallel group), its transport
chosen once from the members' devices (``backend/collectives.py``). The
recovery supervisor re-initializes a shrunken world in-process: it starts
the new default group itself and passes the survivors' ``(rank, world)``.

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
sequences and computes as at cp = 1. ``rdp_sharded`` is True while a step
runs this rank's rows under data or expert parallelism (rdp or ep > 1). The
groups over several data axes (``topology.DATA_AXES``,
``EXPERT_REPLICA_AXES``, ``ROW_AXES``) sit in ``groups`` beside the mesh
axes' (``group(axes)``).

``module_manager`` is the ``module_manager.ModuleManager`` that
``smp.set_activation_checkpointing``, ``smp.set_tensor_parallelism``,
``smp.set_partition`` and their contexts fill (after ``smp.init``, before the
model is built); ``smp.init`` and ``smp.reset`` clear it.

Resilience. ``smp.init`` installs the preemption listener (SIGTERM, on the
main thread), starts the supervisor and the fleet metrics plane; ``shutdown``
stops the plane after the goodput ledger's final publish; ``smp.reset`` puts
SIGTERM's previous handler back and clears the health monitor, the chaos
rules and the supervisor (``resilience/``, ``utils/health.py``,
``utils/fleet.py``). ``bus`` is the native host bus they talk over
(``comm.bus``): None at one rank until something asks for it, and after
``shutdown``, which relays the exit status to rank 0 over it first and then
closes it. ``smp.reset`` keeps it, as the JAX package keeps its
communicator.

Observability. ``smp.init`` walks the telemetry phases of the JAX package's
core (``init/distributed``, ``init/topology`` under the watchdog's guard,
``initialized``), gives the registry this rank and the world size (the dump
paths are rank-qualified when the world is larger than one), builds the
session ``timeline`` (``SMP_TIMELINE_PATH``) and ``memory_metrics``
(``SMP_WRITE_STEP_MEMORY_METRICS``), arms the goodput ledger (``SMP_GOODPUT``
and friends) and the ``SIGUSR2`` profiler trigger, installs the exit hook and
registers ``shutdown`` at exit. ``shutdown`` (``smp.shutdown``) stops the
ledger, closes an open profiler capture, flushes the timeline and dumps the
telemetry and the flight recorder; ``smp.reset`` clears the registry, the
ring, the ledger and the capture.

``tp_registry`` is the ``nn/tp_registry.TensorParallelismRegistry`` that
``DistributedModel`` distributes tp-marked modules from: ``smp.init`` keeps
the one ``smp.tp_register`` may have made before it, or makes one, and
registers the built-ins (``nn.Linear``, ``nn.Embedding``) and, where
``transformers`` has been imported, the HF families' classes. ``smp.reset``
drops it.
"""

import atexit
import os
import socket

from smdistributed_modelparallel_tpu_torch.utils import profiling
from smdistributed_modelparallel_tpu_torch.utils.exceptions import NotInitializedError, SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput
from smdistributed_modelparallel_tpu_torch.utils.random import RngManager
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry, watchdog

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
        self.exit_hook = None
        self._atexit_registered = False
        self._comm = None
        self._clear()

    @property
    def initialized(self):
        return self.cfg is not None

    @property
    def comm(self):
        """The host control-plane communicator (made at first use)."""
        if self._comm is None:
            from smdistributed_modelparallel_tpu_torch.backend.collectives import CollectiveCommunicator

            self._comm = CollectiveCommunicator()
        return self._comm

    @property
    def bus(self):
        """The native host bus (``poll``/``send_bytes``/``recv_bytes``/
        ``barrier``/``peer_down``/``rank``/``world`` ...), None when it is
        not up."""
        return self._comm.bus if self._comm is not None else None

    def initialize(self, cfg, device=None, world=None):
        from smdistributed_modelparallel_tpu_torch.backend.topology import DeviceTopology
        from smdistributed_modelparallel_tpu_torch.nn.auto_distribute import register_builtins
        from smdistributed_modelparallel_tpu_torch.nn.huggingface import register_predefined_hooks
        from smdistributed_modelparallel_tpu_torch.nn.tp_registry import TensorParallelismRegistry

        registry = self.tp_registry
        self._clear()
        telemetry.set_phase("init/distributed")
        launched = "WORLD_SIZE" in os.environ or "LOCAL_RANK" in os.environ
        if world is None:
            rank, world = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
        else:
            rank, world = world
        local_rank = _env_int("LOCAL_RANK", 0)
        if device is None and launched:
            device = _launcher_device(local_rank)
        hosts = [socket.gethostname()]
        if world > 1:
            keys = _start_distributed(world, rank, device)
            hosts = [h for h, _ in keys]
            with watchdog.guard("init/distributed"):
                if self.comm.initialize_bus(rank, world) is None:
                    logger.warning("the native host bus is not up: smp.send/recv_from, the group barriers and the "
                                   "multi-rank resilience paths will raise.")
        telemetry.set_phase("init/topology")
        with watchdog.guard("init/topology"):
            telemetry.process_index = rank
            telemetry.process_count = world
            topology = DeviceTopology(cfg, world)
            if not 0 <= rank < topology.size:
                raise SMPValidationError(f"RANK={rank} lies outside the {topology.size} device(s) of the topology.")
            groups = _build_groups(topology, rank, device, [k for _, k in keys]) if world > 1 else {}
        telemetry.set_phase("initialized")
        self.cfg = cfg
        self.device = device
        self.world_size, self.rank, self.local_rank = world, rank, local_rank
        self.topology = topology
        self.rng_manager = RngManager(cfg.tensor_parallel_seed)
        self.tp_registry = registry or TensorParallelismRegistry()
        register_builtins(self.tp_registry)
        register_predefined_hooks(self.tp_registry)
        self.groups = groups
        self.hosts = hosts
        logger.info("Initialized %s over %d rank(s); this is rank %d.", topology, world, rank)
        if cfg.fp16:
            from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler

            self.loss_scaler = DynamicLossScaler()
        self._start_observability()

    def _start_observability(self):
        from smdistributed_modelparallel_tpu_torch.utils.exit_hook import ExitHook
        from smdistributed_modelparallel_tpu_torch.utils.metrics import StepMemoryMetricsCollector
        from smdistributed_modelparallel_tpu_torch.utils.timeline import Timeline

        if self.exit_hook is None:
            self.exit_hook = ExitHook()
        self.exit_hook.hook()
        if not self._atexit_registered:
            atexit.register(self.shutdown)
            self._atexit_registered = True
        self.timeline = Timeline()
        self.memory_metrics = StepMemoryMetricsCollector()
        _start_resilience()
        # Wall-clock attribution ledger (SMP_GOODPUT and friends): chains
        # onto the set_phase listener, so it arms after telemetry exists.
        goodput.start()
        # SIGUSR2 arms a one-step profiler capture on a live run; the
        # SMP_PROFILE window is read lazily at the first step edge.
        profiling.capture.install_signal()

    def exit_status(self):
        """True when this process is shutting down cleanly."""
        return self.exit_hook.success if self.exit_hook is not None else True

    def shutdown(self):
        """End the session's observability, as the JAX package's core
        shutdown does at world size 1: close the armed serving controllers'
        open scale events, stop the goodput ledger (its final
        publish), derive the exit status, wait for pending checkpoint
        saves, close an open profiler capture, flush the timeline, set the
        ``shutdown`` phase and dump the telemetry (``SMP_TELEMETRY_PATH``)
        and the flight recorder (``SMP_FLIGHT_RECORDER_PATH``). A no-op
        when the framework is not initialized."""
        if self.cfg is None:
            return
        # The serving controller closes its open scale events before the
        # fleet plane (its window source) goes away.
        try:
            from smdistributed_modelparallel_tpu_torch.serving import controller as serving_controller

            serving_controller.shutdown_all()
        except Exception as e:
            logger.warning("serving controller stop failed: %s", e)
        try:
            goodput.stop()
        except Exception as e:
            logger.warning("goodput ledger stop failed: %s", e)
        from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet

        # The fleet plane's final window comes after the goodput ledger's
        # final publish, and its scrape server is gone before the dumps.
        try:
            fleet.stop()
        except Exception as e:
            logger.warning("fleet metrics plane stop failed: %s", e)
        success = self.exit_status()
        if not success:
            logger.error(
                "process %d shutting down after failure (exit_code=%r, exception=%r)",
                self.rank, self.exit_hook.exit_code, self.exit_hook.exception,
            )
        from smdistributed_modelparallel_tpu_torch.backend.core import relay_exit_status
        from smdistributed_modelparallel_tpu_torch.checkpoint import wait_for_checkpoints

        # Before the bus closes (it closes it): the exit status to rank 0.
        relay_exit_status(success)

        try:
            wait_for_checkpoints()
        except Exception as e:
            logger.error("pending async checkpoint save failed during shutdown: %s", e)
        profiling.capture.stop_if_active()
        if self.timeline is not None:
            self.timeline.flush()
        telemetry.set_phase("shutdown")
        telemetry.dump()  # no-op unless SMP_TELEMETRY_PATH is set
        flight_recorder.dump()  # no-op unless SMP_FLIGHT_RECORDER_PATH is set
        self.cfg = None

    def reset(self):
        """Drop the session and clear the observability and resilience
        state: the armed serving controllers, the registry, the flight
        recorder's ring, the goodput ledger, the fleet plane, the health monitor, the profiler capture, the
        preemption listener (SIGTERM gets its previous handler back), the
        supervisor and the chaos rules."""
        from smdistributed_modelparallel_tpu_torch.resilience import reset as resilience_reset
        from smdistributed_modelparallel_tpu_torch.serving import controller as serving_controller
        from smdistributed_modelparallel_tpu_torch.utils import health
        from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet

        serving_controller.reset_all()
        goodput.reset()
        fleet.reset()
        telemetry.reset()
        flight_recorder.clear()
        health.reset()
        profiling.capture.reset()
        resilience_reset()
        self._clear()

    def _clear(self):
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
        self.hosts = None  # every rank's host name, by rank
        self.topology = None
        self.groups = {}
        self.cp_sharded = False
        self.rdp_sharded = False  # a data-parallel step runs this rank's rows
        self.module_manager = None  # the module annotations (module_manager.py)
        self.tp_registry = None
        self.timeline = None  # utils/timeline.Timeline (SMP_TIMELINE_PATH)
        self.memory_metrics = None  # utils/metrics.StepMemoryMetricsCollector
        if self._comm is not None:
            # Barrier ordinals restart with the session on every rank alike.
            self._comm._barrier_seq.clear()

    def check(self):
        if self.cfg is None:
            raise NotInitializedError()

    def group(self, axis):
        """This rank's ``TensorGroup`` along ``axis``, a mesh axis or one of
        ``topology``'s tuples of data axes (None at size 1)."""
        return self.groups.get(axis)

    def sequence_offset(self, local_len):
        """Global position of the first token of this rank's sequence shard
        of ``local_len`` tokens: ``cp_rank * local_len`` inside a cp step,
        else 0."""
        if not self.cp_sharded:
            return 0
        return self.topology.cp_rank(self.rank) * local_len


def _start_resilience():
    """``smp.init``'s resilience bring-up, in the JAX package's order: the
    SIGTERM listener (main thread only), the failure-recovery supervisor
    (``SMP_SUPERVISOR``) and the fleet metrics plane (``SMP_FLEET_INTERVAL``),
    which reads the supervisor's liveness verdicts."""
    from smdistributed_modelparallel_tpu_torch.resilience.preemption import preemption
    from smdistributed_modelparallel_tpu_torch.resilience.supervisor import supervisor
    from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet

    preemption.install()
    supervisor.start()
    fleet.start()


def _start_distributed(world, rank, device):
    """Start ``torch.distributed`` (gloo, the default group's timeout
    ``SMP_COLLECTIVE_TIMEOUT``) if the caller has not, and gather every
    rank's ``(host name, device key)``."""
    import datetime

    import torch
    import torch.distributed as dist

    from smdistributed_modelparallel_tpu_torch.backend.collectives import device_key
    from smdistributed_modelparallel_tpu_torch.resilience.supervisor import _collective_timeout

    if not dist.is_initialized():
        port = os.environ.get("MASTER_PORT", "").strip()
        if not port:
            raise SMPValidationError("WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT to start torch.distributed.")
        addr = os.environ.get("MASTER_ADDR", "localhost").strip() or "localhost"
        timeout = _collective_timeout()
        kw = {"timeout": datetime.timedelta(seconds=timeout)} if timeout else {}
        dist.init_process_group("gloo", init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank, **kw)
    elif dist.get_world_size() != world or dist.get_rank() != rank:
        raise SMPValidationError(
            f"torch.distributed runs rank {dist.get_rank()} of {dist.get_world_size()}, but the launcher "
            f"variables say rank {rank} of {world}."
        )
    if device is not None and torch.device(device).type == "cuda" and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))  # NCCL works on the current device
    keys = [None] * world
    dist.all_gather_object(keys, (socket.gethostname(), device_key(device or "cuda")))
    return keys


def _build_groups(topology, rank, device, keys):
    """Create every group of every mesh axis of size > 1 (all ranks create
    all groups, in one order; ``keys`` are the ranks' device keys); return
    ``{axis: this rank's TensorGroup}``."""
    import torch.distributed as dist

    from smdistributed_modelparallel_tpu_torch.backend.collectives import TensorGroup, choose_transport

    from smdistributed_modelparallel_tpu_torch.backend.topology import DATA_AXES, EXPERT_REPLICA_AXES, PP_AXIS, ROW_AXES

    groups = {}
    for axis, size in zip(topology.axis_names, topology.axis_sizes):
        if size == 1:
            continue
        for ranks in topology.axis_groups(axis):
            transport = choose_transport([keys[r] for r in ranks])
            pg = dist.new_group(ranks, backend=transport)
            extra = {}
            if axis == PP_AXIS and transport == "nccl":
                # The pipeline's backward transfers get a communicator of
                # their own, its transfer headers a gloo group.
                extra = dict(back_pg=dist.new_group(ranks, backend="nccl"),
                             host_pg=dist.new_group(ranks, backend="gloo"))
            if rank in ranks:
                groups[axis] = TensorGroup(ranks, pg, transport, rank, device, **extra)
                note = " (host copies of CUDA tensors)" if transport == "gloo" and keys[rank] != "cpu" else ""
                logger.info("%s group %s: transport %s%s", axis, ranks, transport, note)
    # The groups over several data axes. One with a single axis of size > 1
    # is that axis's group; the others get process groups of their own.
    for axes in (DATA_AXES, EXPERT_REPLICA_AXES, ROW_AXES):
        wide = [a for a in axes if topology.axes_size((a,)) > 1]
        if len(wide) == 1:
            groups[axes] = groups[wide[0]]
        elif wide:
            for ranks in topology.axis_groups(axes):
                transport = choose_transport([keys[r] for r in ranks])
                pg = dist.new_group(ranks, backend=transport)
                if rank in ranks:
                    groups[axes] = TensorGroup(ranks, pg, transport, rank, device)
                    logger.info("%s group %s: transport %s", "x".join(axes), ranks, transport)
    return groups


state = ModelParallelState()
