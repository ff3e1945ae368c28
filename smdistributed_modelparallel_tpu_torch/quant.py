"""fp8 delayed-scaling training matmuls: the training half of ``smp.quant``.

Counterpart of ``smdistributed_modelparallel_tpu/quant.py`` (``:1-608``).
``matmul_precision: fp8`` (env ``SMP_MATMUL_PRECISION``) sends the
``smp.nn`` transformer seams through fp8: e4m3 forward operands with DELAYED
scaling, e5m2 gradients with current scaling. Each quantization slot
(``SITE_SLOTS``) keeps an amax history whose running max sets the next
step's scale (``QuantState``, on ``state.quant_state``).

The JAX package threads the state through one compiled program and gets the
amax observations out of its ``lax.scan``/``nn.scan`` traces with pending
tracers (``scan_drain``, ``absorb_stacked``, ...). The port runs eagerly, so
none of that machinery is needed: ``@smp.step`` installs ``step_trace``
around the whole microbatch loop, every seam call of the step (all layers,
all microbatches, forward only) folds its amax into one running max per slot
(``record``), and ``finalize`` rolls each observed slot's history once per
step. Every microbatch quantizes with the scales the step started with. The
observations, history and scales stay device tensors, so a step adds no host
sync; ``QuantState.state_dict`` is what brings numpy.

Not ported yet: the telemetry gauges and dispatch counters
(``record_quant_state``, ``record_quant_dispatch``; the operations slice),
writing ``quant_states.pt`` (the checkpoint slice), the ``linear_*`` and
``ring_*`` seams (the tensor-parallel slice), and the serving half (int8 KV
and weight-only decode).
"""

import threading

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.ops.matmul_fp8 import matmul_fp8
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

_WARNED = set()


def _warn_once(key, msg, *args):
    if key in _WARNED:
        return
    _WARNED.add(key)
    logger.warning(msg, *args)


def matmul_precision_mode(cfg=None):
    """The effective training matmul precision: the config knob
    (``matmul_precision``, env ``SMP_MATMUL_PRECISION``), canonicalized to
    "bf16" where fp8 cannot engage: pipeline parallelism and ZeRO-3, as in
    the JAX package."""
    cfg = cfg if cfg is not None else state.cfg
    if cfg is None:
        return "bf16"
    mode = getattr(cfg, "matmul_precision", "bf16") or "bf16"
    if mode == "bf16":
        return "bf16"
    if getattr(cfg, "pipeline_parallel_degree", 1) > 1:
        _warn_once(("pp", mode), "matmul_precision=%s requested with pipeline_parallel_degree > 1; fp8 does not "
                   "compose with the pipelined executors yet — keeping bf16 matmuls.", mode)
        return "bf16"
    if getattr(cfg, "sharded_params", "none") == "zero3":
        _warn_once(("zero3", mode), "matmul_precision=%s requested with sharded_params=zero3; fp8 does not "
                   "compose with the ZeRO-3 manual-gradient path yet — keeping bf16 matmuls.", mode)
        return "bf16"
    return mode


# ----------------------------------------------------------------------
# fp8 formats and the static slot registry
# ----------------------------------------------------------------------

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
AMAX_HISTORY = 16

# "<site>.<role>": x the forward input, w the forward weight. The same 19
# names in the same order as the JAX package, so states carry across.
# Backward cotangents carry no slot: they use current scaling.
SITE_SLOTS = (
    "qkv.x", "qkv.w",
    "attn_proj.x", "attn_proj.w",
    "mlp_fc.x", "mlp_fc.w",
    "mlp_proj.x", "mlp_proj.w",
    "linear_col.x", "linear_col.w",
    "linear_row.x", "linear_row.w",
    "ring_ag.x", "ring_ag.w",
    "ring_rs.x", "ring_rs.w",
    "gelu_in.x",
    "attn_q.x", "attn_k.x",
)
_SLOT_INDEX = {s: i for i, s in enumerate(SITE_SLOTS)}


def _slot_fmax(slot):
    return E5M2_MAX if slot.endswith(".g") else E4M3_MAX


def _slot_dtype(slot):
    return torch.float8_e5m2 if slot.endswith(".g") else torch.float8_e4m3fn


_FMAX = {}  # device -> [len(SITE_SLOTS)] fp32 of each slot's format maximum


def _fmax_vector(device):
    vec = _FMAX.get(device)
    if vec is None:
        vec = _FMAX[device] = torch.tensor([_slot_fmax(s) for s in SITE_SLOTS], dtype=torch.float32,
                                           device=device)
    return vec


# ----------------------------------------------------------------------
# QuantState: the delayed-scaling state, on smp.state beside the loss scaler
# ----------------------------------------------------------------------


class QuantState:
    """Per-slot amax history [19, 16] and dequantization scales [19], fp32
    tensors on the step's device.

    ``scale[i]`` is the DIVISOR applied before the f8 cast and the
    multiplier at dequant: ``x8 = cast(clip(x / scale))``. It is
    ``max(history) / fmax`` once a history entry is above 0, and 1.0 before
    (the fresh start)."""

    def __init__(self, device=None):
        n = len(SITE_SLOTS)
        self.amax_history = torch.zeros((n, AMAX_HISTORY), dtype=torch.float32, device=device)
        self.scale = torch.ones((n,), dtype=torch.float32, device=device)

    def to(self, device):
        self.amax_history = self.amax_history.to(device)
        self.scale = self.scale.to(device)
        return self

    def absorb(self, out):
        """Install a step's rolled state (``finalize``'s result)."""
        self.amax_history = out["amax_history"]
        self.scale = out["scale"]

    def state_dict(self):
        return {
            "amax_history": self.amax_history.detach().cpu().numpy().astype(np.float32),
            "scale": self.scale.detach().cpu().numpy().astype(np.float32),
            "slots": list(SITE_SLOTS),
        }

    def load_state_dict(self, sd):
        """Slot-name keyed restore: a state saved under another slot registry
        keeps the intersection (new slots keep their fresh-start 1.0 scale)."""
        hist = self.amax_history.detach().cpu().numpy().copy()
        scale = self.scale.detach().cpu().numpy().copy()
        src_hist = np.asarray(sd["amax_history"], np.float32)
        src_scale = np.asarray(sd["scale"], np.float32)
        h = min(src_hist.shape[1], AMAX_HISTORY)
        for j, name in enumerate(sd.get("slots", ())):
            i = _SLOT_INDEX.get(name)
            if i is None:
                continue
            hist[i, :h] = src_hist[j, :h]
            scale[i] = src_scale[j]
        device = self.scale.device
        self.amax_history = torch.from_numpy(hist).to(device)
        self.scale = torch.from_numpy(scale).to(device)


def ensure_state(device=None):
    """``state.quant_state``, created on first use (fp8 mode only) and kept
    on ``device`` when one is named."""
    qs = state.quant_state
    if qs is None:
        qs = state.quant_state = QuantState(device)
    elif device is not None and qs.scale.device != torch.device(device):
        qs.to(device)
    return qs


# ----------------------------------------------------------------------
# The step's trace context: the step engine installs it around the whole
# microbatch loop; the seams read their slot's scale from it and fold their
# amax observations into it.
# ----------------------------------------------------------------------

_TRACE = threading.local()


class _QuantTrace:
    def __init__(self, qs):
        self.scale = qs.scale   # the step's scales, fixed for the whole step
        self.observed = {}      # slot -> running max (a 0-dim fp32 tensor)

    def scale_for(self, slot):
        return self.scale[_SLOT_INDEX[slot]]

    def record(self, slot, amax):
        prev = self.observed.get(slot)
        self.observed[slot] = amax if prev is None else torch.maximum(prev, amax)


class step_trace:
    """Context manager installing the quant trace for one step. ``qs=None``
    (bf16 mode) installs nothing."""

    def __init__(self, qs):
        self.qs = qs

    def __enter__(self):
        ctx = None if self.qs is None else _QuantTrace(self.qs)
        _TRACE.ctx = ctx
        return ctx

    def __exit__(self, *exc):
        _TRACE.ctx = None
        return False


def _ctx():
    return getattr(_TRACE, "ctx", None)


def fp8_trace_active():
    """Whether the seams run in fp8: a quant trace is installed (only the
    step engine installs one, and only under ``matmul_precision: fp8``).
    Generation and forwards outside a step see False and keep their paths."""
    return _ctx() is not None


def finalize(qs):
    """The step's rolled state: each observed slot's history shifted by one
    (newest at column 0), unobserved slots untouched, and every scale
    refreshed from its history's running max (``max_amax / fmax`` once an
    entry landed, 1.0 before)."""
    ctx = _ctx()
    hist = qs.amax_history
    observed = ctx.observed if ctx is not None else {}
    if observed:
        rows = []
        for i, slot in enumerate(SITE_SLOTS):
            if slot in observed:
                rows.append(torch.cat([observed[slot].reshape(1).float(), hist[i, :-1]]))
            else:
                rows.append(hist[i])
        hist = torch.stack(rows)
    running = hist.max(dim=1).values
    scale = torch.where(running > 0.0, running / _fmax_vector(hist.device), 1.0)
    return {"amax_history": hist, "scale": scale}


# ----------------------------------------------------------------------
# The fp8 ops: delayed-scaling quantize and f8-operand products
# ----------------------------------------------------------------------


def _record_amax(x, slot):
    """Fold this seam call's amax (of the activation-dtype tensor, widened to
    fp32) into the step's observation for ``slot``."""
    _ctx().record(slot, x.detach().abs().amax().float())


def _cast_f8(x, slot):
    """(x8, scale): ``x`` divided by the slot's delayed scale (a true
    division, by a tensor on x's device), clipped to the format's range and
    cast to it."""
    d = _ctx().scale_for(slot)
    fmax = _slot_fmax(slot)
    x8 = (x.float() / d).clamp(-fmax, fmax).to(_slot_dtype(slot))
    return x8, d


def _cast_e5m2_current(g):
    """(g8, scale): e5m2 cotangent with CURRENT scaling, ``amax(g) /
    E5M2_MAX`` from the tensor itself (1.0 when g is all zero)."""
    ag = g.detach().abs().amax().float()
    # A 0-dim divisor on g's device: a true division, where a Python float
    # would be a multiplication by its (inexact) reciprocal on the card.
    d = torch.where(ag > 0.0, ag / torch.full((), E5M2_MAX, device=ag.device), 1.0)
    g8 = (g.float() / d).clamp(-E5M2_MAX, E5M2_MAX).to(torch.float8_e5m2)
    return g8, d


def _f8_dot(a8, b8, scale):
    """fp32 product of two f8 operands (a's last dim contracted with b's
    first; both widened to fp32 exactly, so only the fp32 sums round),
    dequantized by ``scale``."""
    return (a8.float() @ b8.float()) * scale


class _Fp8Mm2d(torch.autograd.Function):
    """``_fp8_mm2d``: x2 [N, K] times the port's w2 [F, K] (+ b [F]).

    Forward: e4m3 operands with the slots' delayed scales; the product by the
    kernel (``use_pallas``) or the plain f8 dot, times ``dx * dw``, plus the
    bias in fp32, one rounding to x's dtype. Backward: the e5m2 cotangent
    against the SAVED f8 operands (no copies of x or w in their own dtype
    survive the forward): dx = (g8 w8)(dg dw), dw = (g8^T x8)(dx dg), db the
    fp32 row sum of g."""

    @staticmethod
    def forward(ctx, x2, w2, b, site, use_pallas):
        x8, dx = _cast_f8(x2, site + ".x")
        w8, dw = _cast_f8(w2, site + ".w")
        if use_pallas:
            y = matmul_fp8(x8, w8) * (dx * dw)
        else:
            y = _f8_dot(x8, w8.t(), dx * dw)
        if b is not None:
            y = y + b.float()
        ctx.save_for_backward(x8, dx, w8, dw)
        ctx.dtypes = (x2.dtype, w2.dtype, None if b is None else b.dtype)
        return y.to(x2.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x8, dx, w8, dw = ctx.saved_tensors
        x_dt, w_dt, b_dt = ctx.dtypes
        g8, dg = _cast_e5m2_current(g)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _f8_dot(g8, w8, dg * dw).to(x_dt)
        if ctx.needs_input_grad[1]:
            gw = _f8_dot(g8.t(), x8, dx * dg).to(w_dt)
        if b_dt is not None and ctx.needs_input_grad[2]:
            gb = g.float().sum(0).to(b_dt)
        return gx, gw, gb, None, None


def fp8_matmul(x, w, site, *, bias=None, n_contract=1, use_pallas=False):
    """``x @ w^T (+ bias)`` through the fp8 delayed-scaling path: x's last
    ``n_contract`` dims contracted with the port's ``nn.Linear``-style weight
    w [F, K] (the JAX package's w [K..., F...] flattened and transposed).
    Returns [..., F] in x's dtype. ``use_pallas`` sends the forward product
    through ``ops/matmul_fp8`` (the fused QKV's rung); every other seam, and
    the backward, keeps the plain f8 product. Records the amax of x and w
    that feeds the next step's scales."""
    lead = x.shape[:x.dim() - n_contract]
    k = int(np.prod(x.shape[x.dim() - n_contract:], dtype=np.int64))
    x2 = x.reshape(-1, k)
    w2 = w.reshape(-1, k)
    _record_amax(x2, site + ".x")
    _record_amax(w2, site + ".w")
    y = _Fp8Mm2d.apply(x2, w2, None if bias is None else bias.reshape(-1), site, use_pallas)
    return y.reshape(*lead, w2.shape[0])


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slot):
        x8, d = _cast_f8(x, slot)
        return (x8.float() * d).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x, slot):
    """fp8 round trip (quantize, dequantize) with the slot's delayed scale
    and a straight-through gradient: the handoff precision of the bias+GELU
    epilogue input and the attention score operands. Records the amax."""
    _record_amax(x, slot)
    return _FakeQuant.apply(x, slot)
