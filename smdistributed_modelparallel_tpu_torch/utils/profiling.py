"""Performance observability: named profiler regions, on-demand
``torch.profiler`` capture, and roofline/MFU attribution (``smp.profiling``).

Counterpart of ``smdistributed_modelparallel_tpu/utils/profiling.py``, with
the same region names, env vars, gauges and breakdown schema. Four pieces:

1. **Named regions** — one vocabulary for every profiling surface.
   ``region(name)`` brackets a host-side phase with
   ``torch.profiler.record_function`` (so the region shows up, by the same
   ``smp_phase/<name>`` name, in a ``torch.profiler`` trace) AND a
   ``state.timeline`` span (so ``scripts/trace_fuse.py`` can align it
   cross-rank). ``named_region(name)`` is the JAX package's in-graph twin;
   the port has no compiled graph to tag, so it is a ``record_function``
   too. Wired through the step engine (microbatches, gradient reduction,
   fetch), ``optimizer.step`` and the serving engine.

2. **On-demand capture** — ``SMP_PROFILE=steps=N:M`` runs
   ``torch.profiler.profile`` (CPU and, where a card is present, CUDA
   activity) around exactly steps N..M (inclusive) and writes its Chrome
   trace into a per-rank directory under ``SMP_PROFILE_PATH`` (default
   ``smp_profile/rank<i>``). ``SIGUSR2`` arms a one-step capture on a live
   run. Disarmed cost is one attribute test per step edge; the start/stop
   overhead of an actual capture is recorded in
   ``smp_profile_overhead_seconds_total``.

3. **Roofline / MFU attribution** — ``roofline(...)`` joins a program's
   FLOPs and bytes with a measured step wall time and the device's peak
   FLOP/s + memory bandwidth (spec-sheet table by device name;
   ``SMP_PEAK_TFLOPS`` / ``SMP_PEAK_GBPS`` override) into MFU, achieved
   bytes/s, arithmetic intensity vs the ridge point, and a
   compute-vs-comm-vs-bubble decomposition of the step time. The JAX
   package reads the FLOPs and bytes from XLA's ``cost_analysis``; the port
   compiles no program and counts the step's FLOPs analytically
   (``lm_step_flops``: the matrix products of a decoder LM, as ``bench.py``
   counts them); its bytes are not counted and stay None. Published as
   ``smp_mfu`` / ``smp_roofline_*`` gauges and rendered by the
   "performance" section of ``scripts/telemetry_report.py``.

4. **Breakdown API** — ``StepBreakdown`` collects named component
   timings and emits them in the one-JSON-object-per-line schema
   ``bench.py`` writes to stderr (``{"component": ..., "ms": ...}``).

Import-hygiene contract: importing this module initializes no device
(``torch.cuda`` is touched only from ``device_peaks`` and the capture).
"""

import atexit
import json
import os
import signal
import sys
import threading
import time

import torch

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

logger = get_logger()

PROFILE_ENV = "SMP_PROFILE"
PROFILE_PATH_ENV = "SMP_PROFILE_PATH"
PEAK_TFLOPS_ENV = "SMP_PEAK_TFLOPS"
PEAK_GBPS_ENV = "SMP_PEAK_GBPS"

# Region names are prefixed so every surface (a torch.profiler trace, our
# Perfetto timeline, trace_fuse's per-phase skew report) can recognize them
# by one convention:
#   host phases:    smp_phase/<name>   (region())
#   in-graph scopes: smp/<subsystem>/<name>  (named_region())
REGION_PREFIX = "smp_phase/"


def _timeline():
    """The live session timeline, or None. Resolved lazily: this module
    must not import backend.state at import time (state pulls in the whole
    core, and collectives/step import *us*)."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    return state.timeline


def _record_function(name):
    """A ``torch.profiler.record_function`` when a profiler is recording,
    else None: the region then costs one flag test (an idle
    ``record_function`` still dispatches two profiler ops)."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Region:
    """One named host-side profiler region (see ``region``)."""

    __slots__ = ("name", "track", "_ta", "_tl", "_begin_us")

    def __init__(self, name, track):
        self.name = name
        self.track = track
        self._ta = None
        self._tl = None
        self._begin_us = 0.0

    def __enter__(self):
        # A named host event in a running torch.profiler session: the
        # "same region names in the profiler trace" contract.
        self._ta = _record_function(self.name)
        tl = _timeline()
        if tl is not None and tl.enabled:
            self._tl = tl
            self._begin_us = tl._now_us()
        return self

    def __exit__(self, *exc):
        if self._tl is not None:
            self._tl.record_event(
                self.name, self._begin_us, self._tl._now_us(),
                track=self.track,
            )
        if self._ta is not None:
            self._ta.__exit__(*exc)
        return False


def region(name, track="phase"):
    """Context manager: one named host-side profiler region.

    Emits the region under ``smp_phase/<name>`` to BOTH observability
    surfaces at once: a ``torch.profiler.record_function`` (visible in a
    profiler capture) and a ``state.timeline`` span on the ``phase``
    track (visible in the fused Perfetto view; ``trace_fuse.py`` computes
    per-phase cross-rank skew from these). No-op-cheap when neither a
    profiler session nor the timeline is active.
    """
    return _Region(REGION_PREFIX + name, track)


class _NamedRegion:
    __slots__ = ("name", "_rf")

    def __init__(self, name):
        self.name = name
        self._rf = None

    def __enter__(self):
        self._rf = _record_function(self.name)
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def named_region(name):
    """The JAX package's in-graph region (a ``jax.named_scope`` whose name
    lands in the compiled HLO's op metadata). Eager PyTorch has no graph
    to tag: the region is a ``record_function`` under the bare name, so a
    profiler trace carries the same vocabulary."""
    return _NamedRegion(name)


# ----------------------------------------------------------------------
# On-demand capture (SMP_PROFILE / SIGUSR2)
# ----------------------------------------------------------------------


def _parse_profile_spec(spec):
    """``steps=N:M`` / ``steps=N`` / bare ``N:M`` -> (first, last)
    inclusive step window. Raises ValueError on anything else."""
    body = spec.strip()
    if body.startswith("steps="):
        body = body[len("steps="):]
    parts = body.split(":")
    if not body or len(parts) > 2:
        raise ValueError(f"unparseable {PROFILE_ENV} spec {spec!r}")
    first = int(parts[0])
    last = int(parts[1]) if len(parts) == 2 else first
    if first < 0 or last < first:
        raise ValueError(
            f"{PROFILE_ENV} window {spec!r} must satisfy 0 <= N <= M"
        )
    return first, last


class ProfileCapture:
    """Programmatic ``torch.profiler`` capture bracketed at step edges.

    The step engine calls ``on_step_begin(step)`` / ``on_step_end(step)``
    around every step. When a window is armed (``SMP_PROFILE=
    steps=N:M`` at init, or a SIGUSR2 received on a live run — which arms
    a one-step window at the next step edge), the capture starts at the
    begin edge of step N and stops at the end edge of step M (after a
    device synchronize, so the window holds the steps' kernels), writing
    the Chrome trace ``steps_<N>_<M>.pt.trace.json`` into
    ``<SMP_PROFILE_PATH>/rank<i>`` so multi-process runs never clobber
    each other (``last_trace`` names it). Disarmed, both hooks are a
    single attribute test.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._parsed_env = False
        self._window = None          # (first, last) inclusive, or None
        self._sig_request = False    # set by the SIGUSR2 handler
        self._installed = False
        self.active = False
        self.last_window = None      # (first, last) of the last capture
        self._started_at = None
        self._last_step = None       # most recent step edge seen
        self._forced_dir = None      # per-capture base dir override
        self._prof = None            # the running torch.profiler.profile
        self.last_trace = None       # Chrome trace of the last capture

    # -- configuration --------------------------------------------------

    def _ensure_spec(self):
        if self._parsed_env:
            return
        self._parsed_env = True
        spec = os.environ.get(PROFILE_ENV, "")
        if not spec:
            return
        try:
            self._window = _parse_profile_spec(spec)
        except ValueError as e:
            logger.warning("%s ignored: %s", PROFILE_ENV, e)

    @property
    def window(self):
        self._ensure_spec()
        return self._window

    def rank_dir(self):
        base = self._forced_dir or os.environ.get(
            PROFILE_PATH_ENV, "smp_profile"
        )
        rank = telemetry.process_index
        return os.path.join(base, f"rank{0 if rank is None else rank}")

    def request_capture(self, path=None):
        """Arm a one-step capture at the next step edge — the SIGUSR2
        path, callable in-process (auto-forensics uses it; ``path``
        overrides the SMP_PROFILE_PATH base for this capture only). Like
        the signal, it defers to a capture already running or a
        configured window still pending."""
        if path is not None and not self.active and self._window is None:
            self._forced_dir = path
        self._sig_request = True

    def install_signal(self):
        """Install the SIGUSR2 trigger (main thread only; re-entrant)."""
        if self._installed:
            return
        try:
            signal.signal(signal.SIGUSR2, self._on_sigusr2)
            self._installed = True
        except (ValueError, OSError, AttributeError) as e:
            # Non-main thread, or a platform without SIGUSR2.
            logger.debug("SIGUSR2 profile trigger unavailable: %s", e)

    def _on_sigusr2(self, signum, frame):
        # Async-signal context: only set a flag; the next step edge arms.
        self._sig_request = True

    # -- step-edge hooks (called by the step engine) --------------------

    def on_step_begin(self, step):
        self._ensure_spec()
        self._last_step = step
        if self._sig_request:
            self._sig_request = False
            if self.active or self._window is not None:
                # A capture is running or a configured window is still
                # pending — the signal must not cancel it (the armed
                # window may be the chip-window trace the run exists to
                # collect).
                logger.info(
                    "SIGUSR2 ignored: profiler capture %s.",
                    "already running" if self.active
                    else f"window {self._window} already armed",
                )
            else:
                # One-step window at the step about to run.
                self._window = (step, step)
                logger.info(
                    "SIGUSR2: profiler capture armed for step %d.", step
                )
        win = self._window
        if win is None or self.active or not (win[0] <= step <= win[1]):
            return
        with self._lock:
            if self.active:
                return
            t0 = time.perf_counter()
            path = self.rank_dir()
            try:
                os.makedirs(path, exist_ok=True)
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
                self._prof = prof
            except Exception as e:
                logger.warning(
                    "profiler capture start failed (%s); window disarmed.", e
                )
                self._window = None
                self._forced_dir = None
                return
            self.active = True
            self._started_at = step
            self._record_overhead(time.perf_counter() - t0)
            telemetry.gauge(
                "smp_profile_active", "1 while a profiler capture is running"
            ).set(1)
            logger.info(
                "profiler capture started at step %d (window %d..%d) -> %s",
                step, win[0], win[1], path,
            )

    def on_step_end(self, step, outputs=None):
        if not self.active:
            return
        win = self._window
        if win is not None and step < win[1]:
            return
        # Make the captured window actually contain this step's device
        # execution (launches are async): block before stopping the trace.
        _synchronize()
        self._stop(step)

    def _stop(self, step):
        with self._lock:
            if not self.active:
                return
            t0 = time.perf_counter()
            first = self._started_at if self._started_at is not None else step
            prof, self._prof = self._prof, None
            try:
                prof.stop()
                path = os.path.join(self.rank_dir(), f"steps_{first}_{step}.pt.trace.json")
                prof.export_chrome_trace(path)
                self.last_trace = path
            except Exception as e:  # pragma: no cover
                logger.warning("profiler capture stop failed: %s", e)
            self.active = False
            self.last_window = (first, step)
            self._window = None       # window consumed; SIGUSR2 can re-arm
            self._record_overhead(time.perf_counter() - t0)
            telemetry.gauge(
                "smp_profile_active", "1 while a profiler capture is running"
            ).set(0)
            telemetry.counter(
                "smp_profile_captures_total", "completed profiler captures"
            ).inc()
            telemetry.gauge(
                "smp_profile_last_first_step",
                "first step of the last profiler capture",
            ).set(first)
            telemetry.gauge(
                "smp_profile_last_last_step",
                "last step of the last profiler capture",
            ).set(step)
            logger.info(
                "profiler capture stopped: steps %d..%d -> %s",
                first, step, self.rank_dir(),
            )
            self._forced_dir = None

    @staticmethod
    def _record_overhead(seconds):
        telemetry.counter(
            "smp_profile_overhead_seconds_total",
            "host seconds spent starting/stopping profiler captures "
            "(zero unless a capture ran)",
        ).inc(seconds)

    def stop_if_active(self):
        """Shutdown/atexit hook: a run that ends mid-window still gets a
        usable trace rather than a torn session. The recorded window ends
        at the last step edge this capture actually saw."""
        if self.active:
            last = self._last_step
            if last is None:
                last = self._started_at if self._started_at is not None else -1
            self._stop(last)

    def reset(self):
        """Testing hook: stop any live capture and re-read the env."""
        self.stop_if_active()
        self._parsed_env = False
        self._window = None
        self._sig_request = False
        self.last_window = None
        self._started_at = None
        self._last_step = None
        self._forced_dir = None
        self.last_trace = None


def _synchronize():
    """Wait for the device's queued work, where a card is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


capture = ProfileCapture()
atexit.register(capture.stop_if_active)


# ----------------------------------------------------------------------
# Roofline / MFU attribution
# ----------------------------------------------------------------------

# Peak dense bf16 TFLOP/s and memory GB/s per device, by fragment of the
# lower-cased ``torch.cuda.get_device_name`` (public spec sheets): the H100
# SXM part. Another variant (PCIe, NVL) matches no row and gets None —
# never a guess; SMP_PEAK_TFLOPS / SMP_PEAK_GBPS override.
_PEAK_TFLOPS = (
    ("nvidia h100 80gb hbm3", 989.0),
)
_PEAK_GBPS = (
    ("nvidia h100 80gb hbm3", 3350.0),
)


def _env_float(name):
    raw = os.environ.get(name, "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r (want a number); ignored.", name, raw)
        return None


def _device_kind(device):
    """The lower-cased name of a CUDA ``device`` (None: the current one),
    or "" for any other device or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return ""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device).lower()


def device_peaks(device=None):
    """(peak FLOP/s, peak bytes/s) for the attribution denominator.

    ``SMP_PEAK_TFLOPS`` / ``SMP_PEAK_GBPS`` override (required on
    devices the spec table does not know, e.g. the CPU);
    otherwise looked up by device name. Unknown entries are None —
    callers must treat MFU as unavailable rather than fabricate one.
    """
    flops = _env_float(PEAK_TFLOPS_ENV)
    flops = flops * 1e12 if flops is not None else None
    bps = _env_float(PEAK_GBPS_ENV)
    bps = bps * 1e9 if bps is not None else None
    if flops is None or bps is None:
        kind = _device_kind(device)
        if flops is None:
            for frag, v in _PEAK_TFLOPS:
                if frag in kind:
                    flops = v * 1e12
                    break
        if bps is None:
            for frag, v in _PEAK_GBPS:
                if frag in kind:
                    bps = v * 1e9
                    break
    return flops, bps


class RooflineReport:
    """One step program's roofline attribution (plain attributes +
    ``as_dict``). ``None`` fields mean "not attributable" (unknown peak,
    no FLOP or byte count), never a guess."""

    def __init__(self, **kw):
        self.name = kw.get("name")
        self.step_time_s = kw.get("step_time_s")
        self.flops = kw.get("flops")
        self.bytes_accessed = kw.get("bytes_accessed")
        self.peak_flops_per_s = kw.get("peak_flops_per_s")
        self.peak_bytes_per_s = kw.get("peak_bytes_per_s")
        self.mfu = kw.get("mfu")
        self.achieved_flops_per_s = kw.get("achieved_flops_per_s")
        self.achieved_bytes_per_s = kw.get("achieved_bytes_per_s")
        self.arithmetic_intensity = kw.get("arithmetic_intensity")
        self.ridge_intensity = kw.get("ridge_intensity")
        self.bound = kw.get("bound")        # "compute" | "memory" | None
        self.compute_s = kw.get("compute_s")
        self.memory_s = kw.get("memory_s")
        self.bubble_fraction = kw.get("bubble_fraction")
        self.bubble_s = kw.get("bubble_s")
        self.comm_s = kw.get("comm_s")

    def as_dict(self):
        return {
            k: getattr(self, k)
            for k in (
                "name", "step_time_s", "flops", "bytes_accessed",
                "peak_flops_per_s", "peak_bytes_per_s", "mfu",
                "achieved_flops_per_s", "achieved_bytes_per_s",
                "arithmetic_intensity", "ridge_intensity", "bound",
                "compute_s", "memory_s", "bubble_fraction", "bubble_s",
                "comm_s",
            )
        }


def _live_gauge_max(name):
    """Max value across a live gauge family's series (None when absent)."""
    fam = telemetry._families.get(name)
    if fam is None:
        return None
    with fam._lock:
        children = list(fam._children.values())
    return max((c.value for c in children), default=None)


def roofline(name="step", *, step_time_s, flops=None, bytes_accessed=None,
             bubble_fraction=None, device=None,
             peak_flops=None, peak_bytes_per_s=None, publish=True):
    """Join program cost with measured wall time into a roofline report.

    Args:
      name: label for the published gauges (``step=<name>``).
      step_time_s: measured wall time of one step of this program.
      flops / bytes_accessed: the program's cost (the JAX package also
        takes a ``compiled`` executable to read them from; the port has
        none). A missing piece leaves what needs it None.
      bubble_fraction: pipeline idle fraction; defaults to the live
        ``smp_pipeline_bubble_fraction`` gauge (0.0 when no pipeline).
      device / peak_flops / peak_bytes_per_s: attribution denominators;
        default to ``device_peaks`` (spec table + the peak env overrides).
      publish: set the ``smp_mfu`` / ``smp_roofline_*`` gauges.

    Decomposition (published per label): ``compute_s`` is the ideal
    compute-bound time ``flops / peak_flops``; ``bubble_s`` is
    ``bubble_fraction * step_time``; ``comm_s`` is the residual — time
    the roofline model cannot attribute to ideal compute or schedule
    bubble (collectives, memory-bound stalls, host overhead).
    ``memory_s`` (``bytes / peak_bw``) is reported alongside as the
    bandwidth bound.
    """
    if peak_flops is None or peak_bytes_per_s is None:
        d_flops, d_bps = device_peaks(device)
        peak_flops = peak_flops if peak_flops is not None else d_flops
        peak_bytes_per_s = (
            peak_bytes_per_s if peak_bytes_per_s is not None else d_bps
        )
    if bubble_fraction is None:
        bubble_fraction = _live_gauge_max("smp_pipeline_bubble_fraction")
        bubble_fraction = 0.0 if bubble_fraction is None else bubble_fraction

    dt = float(step_time_s) if step_time_s else None
    achieved_f = flops / dt if (flops is not None and dt) else None
    achieved_b = bytes_accessed / dt if (bytes_accessed is not None and dt) else None
    mfu = (
        achieved_f / peak_flops
        if (achieved_f is not None and peak_flops) else None
    )
    ai = (
        flops / bytes_accessed
        if (flops is not None and bytes_accessed) else None
    )
    ridge = (
        peak_flops / peak_bytes_per_s
        if (peak_flops and peak_bytes_per_s) else None
    )
    bound = None
    if ai is not None and ridge is not None:
        bound = "compute" if ai >= ridge else "memory"
    compute_s = flops / peak_flops if (flops is not None and peak_flops) else None
    memory_s = (
        bytes_accessed / peak_bytes_per_s
        if (bytes_accessed is not None and peak_bytes_per_s) else None
    )
    bubble_s = bubble_fraction * dt if dt is not None else None
    comm_s = None
    if dt is not None and compute_s is not None and bubble_s is not None:
        comm_s = max(dt - compute_s - bubble_s, 0.0)

    report = RooflineReport(
        name=name, step_time_s=dt, flops=flops,
        bytes_accessed=bytes_accessed, peak_flops_per_s=peak_flops,
        peak_bytes_per_s=peak_bytes_per_s, mfu=mfu,
        achieved_flops_per_s=achieved_f, achieved_bytes_per_s=achieved_b,
        arithmetic_intensity=ai, ridge_intensity=ridge, bound=bound,
        compute_s=compute_s, memory_s=memory_s,
        bubble_fraction=bubble_fraction, bubble_s=bubble_s, comm_s=comm_s,
    )
    if publish:
        _publish(report)
    return report


def _publish(r):
    lab = dict(step=r.name)
    for value, metric, help_ in (
        (r.mfu, "smp_mfu",
         "model FLOPs utilization of the last measured step"),
        (r.flops, "smp_roofline_flops",
         "program FLOPs joined into the roofline report"),
        (r.bytes_accessed, "smp_roofline_bytes",
         "program bytes accessed joined into the roofline report"),
        (r.step_time_s, "smp_roofline_step_seconds",
         "measured step wall time of the roofline report"),
        (r.achieved_flops_per_s, "smp_roofline_achieved_flops_per_s",
         "achieved FLOP/s of the last measured step"),
        (r.achieved_bytes_per_s, "smp_roofline_achieved_bytes_per_s",
         "achieved HBM bytes/s of the last measured step"),
        (r.arithmetic_intensity, "smp_roofline_arithmetic_intensity",
         "program FLOPs per byte accessed"),
        (r.ridge_intensity, "smp_roofline_ridge_intensity",
         "device ridge point (peak FLOP/s / peak bytes/s)"),
        (r.compute_s, "smp_roofline_compute_seconds",
         "ideal compute-bound time (flops / peak FLOP/s)"),
        (r.memory_s, "smp_roofline_memory_seconds",
         "ideal bandwidth-bound time (bytes / peak bytes/s)"),
        (r.bubble_s, "smp_roofline_bubble_seconds",
         "pipeline-bubble share of the step time"),
        (r.comm_s, "smp_roofline_comm_seconds",
         "residual step time not attributed to ideal compute or bubble "
         "(collectives, memory stalls, host overhead)"),
        (r.peak_flops_per_s, "smp_roofline_peak_flops_per_s",
         "peak FLOP/s used as the MFU denominator"),
        (r.peak_bytes_per_s, "smp_roofline_peak_bytes_per_s",
         "peak bytes/s used as the bandwidth denominator"),
    ):
        if value is not None:
            telemetry.gauge(metric, help_).labels(**lab).set(float(value))
    if r.bound is not None:
        telemetry.gauge(
            "smp_roofline_compute_bound",
            "1 when arithmetic intensity sits above the ridge point",
        ).labels(**lab).set(1.0 if r.bound == "compute" else 0.0)


ROOFLINE_SAMPLE_EVERY = 16


def should_sample_step(step):
    """Steps where the engine blocks on the step's outputs to measure an
    EXACT wall time for the roofline gauges (step 1, then every 16th).

    Without a block, async dispatch returns long before the device
    finishes; dividing program FLOPs by that lower-bound time would
    publish an upper-bound — i.e. wrong, possibly >1.0 — MFU. Sampling
    keeps the gauges honest at ~zero throughput cost (one drained
    dispatch queue per 16 steps)."""
    return step % ROOFLINE_SAMPLE_EVERY == 1


def lm_step_flops(module, batch, seq, backward=True):
    """The matrix-product FLOPs of one step of a decoder LM over ``batch``
    sequences of ``seq`` tokens: the count the port publishes in place of
    XLA's ``cost_analysis`` (``bench.py``'s ``_model_flops_per_step``, with
    the MLP width F and the attention width A = heads x head size of the
    module). A forward pass takes, per layer, 2 x tokens x (4 D A + 2 D F)
    for the QKV, output and MLP products, 4 x tokens x seq x A for QK^T and
    PV over the full score matrix, and 2 x tokens x D x V for the LM head;
    a training step (``backward``) three times that. Element-wise work
    (norms, softmax, GELU) is not counted. None for a module this count
    does not describe (mixture of experts, cross-attention, no LM head,
    not a transformer LM)."""
    cfg = getattr(module, "config", None)
    if not isinstance(cfg, dict):
        return None
    if "num_layers" in cfg and "hidden_size" in cfg:  # smp.nn DistributedTransformerLMHead
        if cfg.get("num_experts") or cfg.get("add_cross_attention") or not cfg.get("add_lm_head", True):
            return None
        L, D, V = cfg["num_layers"], cfg["hidden_size"], cfg["vocab_size"]
        F = cfg["intermediate_size"]
        A = cfg["num_attention_heads"] * cfg["attention_head_size"]
    elif "n_layers" in cfg and "d_model" in cfg:  # the zoo's TransformerLM
        L, D, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
        F, A = cfg.get("d_ff") or 4 * D, D
    else:
        return None
    tokens = batch * seq
    forward = L * (2 * tokens * (4 * D * A + 2 * D * F) + 4 * tokens * seq * A) + 2 * tokens * D * V
    return float(3 * forward if backward else forward)


def record_step_roofline(name, step_time_s, flops, bytes_accessed=None):
    """Per-step hook from the step engine: publish ``smp_mfu`` and the
    decomposition of the step ``name`` from its counted ``flops``, costing
    a few float ops. Skipped when the count is missing. The engine only
    calls this with EXACT step times — a sampled ``should_sample_step``
    step, timed after a device synchronize — never the async-launch lower
    bound."""
    if flops is None or not step_time_s:
        return None
    return roofline(name, step_time_s=step_time_s, flops=flops, bytes_accessed=bytes_accessed)


# ----------------------------------------------------------------------
# Breakdown API (scripts/perf_probe.py, scripts/step_breakdown.py, bench)
# ----------------------------------------------------------------------


class StepBreakdown:
    """Named component timings, emitted one JSON object per line in the
    exact schema ``bench.py`` writes to stderr:
    ``{"component": <name>, "ms": <float>, ...extras}``.

    ``record`` takes seconds (the JSON carries ms, like bench); every
    component also lands in the ``smp_breakdown_ms`` telemetry gauge so a
    probe run's breakdown rides in its telemetry dump.
    """

    def __init__(self, context=None):
        self._rows = []
        self._context = dict(context or {})

    @property
    def rows(self):
        return list(self._rows)

    def record(self, component, seconds, **extras):
        row = dict(self._context)
        row.update(extras)
        row["component"] = component
        row["ms"] = round(float(seconds) * 1e3, 3)
        self._rows.append(row)
        telemetry.gauge(
            "smp_breakdown_ms", "perf-probe component wall time (ms)"
        ).labels(component=component).set(float(seconds) * 1e3)
        return row

    def time(self, component, fn, *args, iters=10, readback=None, **extras):
        """Warmup call + timed loop; records the mean per-iteration wall
        time. ``readback`` forces a device->host sync (defaults to
        ``torch.cuda.synchronize`` where a card is in use)."""
        out = fn(*args)
        self._force(out, readback)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        self._force(out, readback)
        dt = (time.perf_counter() - t0) / iters
        self.record(component, dt, iters=iters, **extras)
        return out, dt

    @staticmethod
    def _force(out, readback):
        if readback is not None:
            readback(out)
        else:
            _synchronize()

    def emit(self, stream=None):
        """Write every recorded row as one JSON line (bench schema).
        Returns the rows."""
        stream = sys.stderr if stream is None else stream
        for row in self._rows:
            stream.write(json.dumps(row) + "\n")
        stream.flush()
        return self.rows
