"""Step memory metrics.

Counterpart of ``smdistributed_modelparallel_tpu/utils/metrics.py`` (reference
``StepMemoryMetricsCollector``, ``torch/step.py:69-115``, env
``SMP_WRITE_STEP_MEMORY_METRICS``: a per-step file of allocator peaks).

The allocator statistics come from ``torch.cuda.memory_stats(device)`` in
place of the JAX device's ``memory_stats()``, under the same gauge names and
the label key ``device`` (the value is ``str(device)``, e.g. ``cuda:0``), and
the per-step file keeps the same keys. A device without allocator statistics
(the CPU, as XLA:CPU) records nothing. The JAX package's compile report
(``one_time_compile_report``, XLA's ``cost_analysis``) has no counterpart:
the port compiles no program.
"""

import json
import os

import torch

from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

MEMORY_METRICS_ENV = "SMP_WRITE_STEP_MEMORY_METRICS"

# The JAX allocator's keys, from the CUDA caching allocator's.
_STAT_KEYS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
)


def _device_memory_stats(device):
    """``memory_stats()`` in the JAX device's keys for a CUDA device, or {}
    for a device without allocator statistics. ``bytes_limit`` is the
    device's total memory; ``largest_alloc_size`` has no CUDA counterpart
    and is left out, as a JAX backend leaves out what it does not track."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(device)
    out = {key: int(ms[src]) for key, src in _STAT_KEYS if src in ms}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
    return out


def _local_devices():
    """The devices this process computes on: the model's (``smp.init``'s,
    else the current CUDA device), the counterpart of
    ``jax.local_devices()`` at one device a process. A CUDA device carries
    its index (``cuda:0``, as ``str`` of a JAX GPU device reads)."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    if state.model is not None:
        device = torch.device(state.model.device)
    elif state.device is not None:
        device = torch.device(state.device)
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        return []
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return [device]


def record_device_memory_telemetry():
    """Per-device allocator gauges for the telemetry report (peak device
    memory is what the step report CLI surfaces). A device without
    allocator stats records nothing. Runs on every step edge:
    ``smp.telemetry.report()`` / ``render_prometheus()`` are live surfaces
    that carry memory gauges without any env var; the cost is one host-side
    read of the caching allocator's counters (no device sync)."""
    for d in _local_devices():
        ms = _device_memory_stats(d)
        for key, metric in (
            ("peak_bytes_in_use", "smp_device_peak_hbm_bytes"),
            ("bytes_in_use", "smp_device_hbm_bytes_in_use"),
            ("bytes_limit", "smp_device_hbm_bytes_limit"),
        ):
            if ms.get(key) is not None:
                telemetry.gauge(
                    metric, "device allocator stats (memory_stats)"
                ).labels(device=str(d)).set(int(ms[key]))


class StepMemoryMetricsCollector:
    """Writes per-step device memory metrics when enabled by env."""

    def __init__(self, path=None):
        self.enabled = os.environ.get(MEMORY_METRICS_ENV, "") not in ("", "0")
        self.path = path or os.environ.get(
            "SMP_STEP_MEMORY_METRICS_PATH", "smp_step_memory_metrics.jsonl"
        )

    def record_step(self, step):
        if not self.enabled:
            return
        stats = {}
        for d in _local_devices():
            ms = _device_memory_stats(d)
            stats[str(d)] = {
                k: ms.get(k)
                for k in (
                    "bytes_in_use",
                    "peak_bytes_in_use",
                    "largest_alloc_size",
                    "bytes_limit",
                )
                if k in ms
            }
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "devices": stats}) + "\n")
