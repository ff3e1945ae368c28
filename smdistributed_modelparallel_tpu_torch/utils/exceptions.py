"""Typed exception hierarchy of the PyTorch port.

A copy of ``smdistributed_modelparallel_tpu/utils/exceptions.py``: the same
classes under the same names, so callers catch the same errors from both
packages.
"""


class SMPError(Exception):
    """Base class for all framework errors."""


class SMPValidationError(SMPError):
    """User-facing configuration / usage validation error."""


class SMPRuntimeError(SMPError):
    """Internal invariant violation."""


class SMPUnsupportedError(SMPError):
    """Feature exists in the reference API but is not supported in this build."""


class NotInitializedError(SMPValidationError):
    def __init__(self, what="smp"):
        super().__init__(
            f"{what} has not been initialized. Call smp.init(config) before using the framework."
        )


class ConfigError(SMPValidationError):
    """Invalid configuration value or combination (schema validation)."""


class DeviceCountError(SMPValidationError):
    def __init__(self, required, available):
        super().__init__(
            f"Model-parallel degree product ({required} = pipeline * tensor * context "
            f"* expert) must divide the device count ({available} available)."
        )


class MicrobatchError(SMPValidationError):
    """Batch not divisible into the configured number of microbatches."""


class PartitionError(SMPValidationError):
    """Invalid manual partition assignment or partitioner failure."""


class TensorParallelismError(SMPValidationError):
    """Invalid tensor-parallelism registration or module distribution failure."""


class StepUsageError(SMPValidationError):
    """Misuse of @smp.step (e.g. model.backward never called, nested steps)."""


class CheckpointError(SMPValidationError):
    """Checkpoint save/load failure or incompatible smp config on resume."""


class SMPWatchdogTimeout(SMPRuntimeError):
    """A watchdog-guarded wait (collective, device probe) stalled past
    SMP_WATCHDOG_TIMEOUT; diagnostics were dumped (utils/telemetry.py)."""


class SMPPeerLost(SMPRuntimeError):
    """A native-bus peer is unreachable: the send path exhausted its
    bounded retry/backoff budget (``SMP_BUS_SEND_RETRIES``), or a receive
    /barrier wait found the peer's link already marked dead
    (``backend/native.py``). Carries ``peer`` (process index) so recovery
    logic can exclude the dead rank instead of parsing the message."""

    def __init__(self, peer, message=None):
        self.peer = int(peer)
        super().__init__(
            message or f"native-bus peer (process {peer}) is unreachable."
        )


class SMPCollectiveTimeout(SMPRuntimeError):
    """A host collective exceeded ``SMP_COLLECTIVE_TIMEOUT``. Unlike the
    global watchdog (which dumps and raises for ANY stall), this is a
    per-operation deadline with enough structure for the failure-recovery
    supervisor to distinguish "slow" from "gone": it carries the group
    name, the phase (barrier / recv / ...), and the group's last
    flight-recorder collective sequence number — the coordinate at which
    this rank's collective stream stopped."""

    def __init__(self, group, phase, last_seq=-1, message=None):
        self.group = str(group)
        self.phase = str(phase)
        self.last_seq = int(last_seq)
        super().__init__(
            message
            or f"host collective over {group} timed out in phase "
            f"'{phase}' (last collective seq {last_seq}; bound set by "
            "SMP_COLLECTIVE_TIMEOUT)."
        )


class SMPRecoveryError(SMPRuntimeError):
    """In-job failure recovery could not complete (rendezvous failed, no
    common committed checkpoint, world re-initialization failed). The
    supervisor dumps its detector state + the flight-recorder ring before
    raising this (``resilience/supervisor.py``)."""


class SMPEvicted(SMPRuntimeError):
    """Surviving peers reformed the world WITHOUT this rank (it was
    classified dead/wedged — e.g. it was wedged long enough to exhaust
    ``SMP_WEDGE_TIMEOUT`` and came back after the shrink). The rank must
    exit instead of training on as a split-brain singleton."""


class DelayedParamError(SMPRuntimeError):
    """Materialization of delayed-initialized parameters failed."""


class OffloadError(SMPRuntimeError):
    """Activation offloading failure."""
