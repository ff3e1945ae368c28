"""fp8 delayed-scaling training matmuls and int8 serving: ``smp.quant``.

Counterpart of ``smdistributed_modelparallel_tpu/quant.py``.
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

The serving half (``quant.py:110-150``, ``:608-736``): the knobs
``SMP_KV_QUANT`` and ``SMP_DECODE_WEIGHTS`` (``kv_quant_mode``,
``decode_weights_mode``, ``serving_key_suffix``), weight-only int8
(``quantize_decode_params``, ``dequantize_decode_params``,
``fake_quant_decode_params``) and the int8 paged KV (``kv_quantize_append``,
``kv_dequantize_gather``). Weights quantize in the JAX tree's layout, so the
scales are the JAX package's: one a last-axis channel over every layer of the
stack (see ``_weight_leaf``).

Telemetry, as in the JAX package: ``QuantState.absorb`` publishes the
latest amax and the scale in force per slot (``record_quant_state``, the
``smp_quant_amax`` / ``smp_quant_scale`` gauges; reading them copies them to
the host once a step); the dispatch counter ``smp_quant_dispatch_total``
ticks at the layers' fp8 seams, ``linear_*`` included
(``nn/utils.program_tick``), and at the serving engine's construction
(``decode_weights``, ``kv_cache``).

Not ported yet: writing ``quant_states.pt`` (the checkpoint slice), and the
``ring_*`` seams (the tensor-parallel slice), whose fp8 dispatch counts come
with them.
"""

import contextlib
import functools
import os
import threading

import numpy as np
import torch
import torch.distributed

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
        """Install a step's rolled state (``finalize``'s result) and publish
        the telemetry gauges (``smp_quant_amax`` / ``smp_quant_scale``,
        latest per slot)."""
        from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_quant_state

        self.amax_history = out["amax_history"]
        self.scale = out["scale"]
        record_quant_state(SITE_SLOTS, self.amax_history[:, 0].tolist(), self.scale.tolist())

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


def current_trace():
    """This thread's quant trace (None outside an fp8 step)."""
    return _ctx()


@contextlib.contextmanager
def use_trace(trace):
    """Install ``trace`` on this thread for the block: a checkpointed
    region's recompute, which the autograd engine may run on another thread
    than the step's, quantizes with the step's trace (``parallel/memory``)."""
    outer, _TRACE.ctx = _ctx(), trace
    try:
        yield
    finally:
        _TRACE.ctx = outer


def finalize(qs, group=None):
    """The step's rolled state: each observed slot's history shifted by one
    (newest at column 0), unobserved slots untouched, and every scale
    refreshed from its history's running max (``max_amax / fmax`` once an
    entry landed, 1.0 before). ``group``: the ranks whose observations are
    parts of one global tensor's (the tp group): each slot's amax is first
    the max over the group, in one exchange, so that every rank rolls the
    JAX package's global state (a replicated operand's max is its own)."""
    ctx = _ctx()
    hist = qs.amax_history
    observed = ctx.observed if ctx is not None else {}
    if observed and group is not None:
        slots = [slot for slot in SITE_SLOTS if slot in observed]
        maxed = group.reduced(torch.stack([observed[slot].reshape(()).float() for slot in slots]),
                              torch.distributed.ReduceOp.MAX)
        observed = dict(zip(slots, maxed.unbind(0)))
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


def _cast_e5m2_current(g, group=None):
    """(g8, scale): e5m2 cotangent with CURRENT scaling, ``amax(g) /
    E5M2_MAX`` from the tensor itself (1.0 when g is all zero). ``group``:
    g is this rank's shard of the whole cotangent (a column-parallel
    product's output block at tp > 1), whose amax is the max over the
    group's, as the JAX package's amax of the global array is."""
    ag = g.detach().abs().amax().float()
    if group is not None:
        ag = group.reduced(ag, torch.distributed.ReduceOp.MAX)
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
    def forward(ctx, x2, w2, b, site, use_pallas, grad_group):
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
        ctx.grad_group = grad_group
        return y.to(x2.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x8, dx, w8, dw = ctx.saved_tensors
        x_dt, w_dt, b_dt = ctx.dtypes
        g8, dg = _cast_e5m2_current(g, ctx.grad_group)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _f8_dot(g8, w8, dg * dw).to(x_dt)
        if ctx.needs_input_grad[1]:
            gw = _f8_dot(g8.t(), x8, dx * dg).to(w_dt)
        if b_dt is not None and ctx.needs_input_grad[2]:
            gb = g.float().sum(0).to(b_dt)
        return gx, gw, gb, None, None, None


def fp8_matmul(x, w, site, *, bias=None, n_contract=1, use_pallas=False, grad_group=None):
    """``x @ w^T (+ bias)`` through the fp8 delayed-scaling path: x's last
    ``n_contract`` dims contracted with the port's ``nn.Linear``-style weight
    w [F, K] (the JAX package's w [K..., F...] flattened and transposed).
    Returns [..., F] in x's dtype. ``use_pallas`` sends the forward product
    through ``ops/matmul_fp8`` (the fused QKV's rung); every other seam, and
    the backward, keeps the plain f8 product. Records the amax of x and w
    that feeds the next step's scales. ``grad_group``: the output is this
    rank's block of a column-parallel product, so the backward's current
    scale comes from the cotangent's amax over the group."""
    lead = x.shape[:x.dim() - n_contract]
    k = int(np.prod(x.shape[x.dim() - n_contract:], dtype=np.int64))
    x2 = x.reshape(-1, k)
    w2 = w.reshape(-1, k)
    _record_amax(x2, site + ".x")
    _record_amax(w2, site + ".w")
    y = _Fp8Mm2d.apply(x2, w2, None if bias is None else bias.reshape(-1), site, use_pallas, grad_group)
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


# ----------------------------------------------------------------------
# Serving: the int8 knobs
# ----------------------------------------------------------------------


def kv_quant_mode():
    """Serving paged-KV pool precision: ``SMP_KV_QUANT`` (default "none";
    "int8" stores the pools int8 with per-block, per-head scales)."""
    v = os.environ.get("SMP_KV_QUANT", "none").strip().lower() or "none"
    if v in ("", "0", "none", "off", "bf16"):
        return "none"
    if v != "int8":
        raise ValueError(f"SMP_KV_QUANT={v!r}: expected 'int8' or unset/none.")
    return "int8"


def decode_weights_mode():
    """Serving and decode weight precision: ``SMP_DECODE_WEIGHTS`` (default
    "none"; "int8" = weight-only int8 with per-output-channel scales,
    quantized once where the weights are loaded)."""
    v = os.environ.get("SMP_DECODE_WEIGHTS", "none").strip().lower() or "none"
    if v in ("", "0", "none", "off", "bf16"):
        return "none"
    if v != "int8":
        raise ValueError(f"SMP_DECODE_WEIGHTS={v!r}: expected 'int8' or unset/none.")
    return "int8"


def serving_key_suffix():
    """The quant knobs as the JAX package appends them to its serving
    programs' cache keys: nothing at the defaults, one fact a knob that is
    on."""
    suffix = ()
    if kv_quant_mode() != "none":
        suffix += (("kv_quant", kv_quant_mode()),)
    if decode_weights_mode() != "none":
        suffix += (("decode_weights", decode_weights_mode()),)
    return suffix


# ----------------------------------------------------------------------
# Serving: weight-only int8 (per-output-channel scales)
# ----------------------------------------------------------------------

# Inside a compiled JAX program XLA folds ``x / 127.0`` into ``x * (1 /
# 127)``, the reciprocal rounded to fp32 (a true division outside one, as in
# the JAX engine's eager quantization at load).
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _divide(x, c):
    """``x / c`` as a true division on any device: torch multiplies by the
    reciprocal of a Python divisor on the card."""
    return x / torch.full((1,), c, dtype=x.dtype, device=x.device)


def _jax_layout(module):
    """``(to_jax, from_jax)`` between ``module``'s state dict and the JAX
    package's flat parameter tree, on the tensors' device
    (``convert.jax_layout``); the zoo ``TransformerLM``'s for a module of
    another class."""
    from smdistributed_modelparallel_tpu_torch import convert

    return convert.jax_layout(module, host=False) or (
        functools.partial(convert.params_to_jax, host=False), convert.params_from_jax)


def _weight_leaf(leaf):
    """Weight-only int8 eligibility, the JAX package's: a floating leaf of
    the JAX tree with at least two axes. The JAX layers are stacked on a
    leading layer axis (flax ``nn.scan``), so the stack's biases and
    LayerNorm vectors ([L, D]) are eligible too, and one scale spans a
    channel in every layer."""
    return torch.is_floating_point(leaf) and leaf.dim() >= 2


def _quantize_flat(flat, compiled):
    """``{"q", "s"}`` over a flat JAX-layout dict: an eligible leaf becomes
    int8 with an fp32 scale a last-axis channel (amax over every other axis,
    / 127, at least 1e-12); the rest rides unchanged with a 0-d zero scale.
    ``compiled``: the scale divides as the JAX package's compiled programs
    do (a multiply by the reciprocal), else truly, as its eager code does."""
    q, s = {}, {}
    for key, leaf in flat.items():
        if not _weight_leaf(leaf):
            q[key], s[key] = leaf, torch.zeros((), dtype=torch.float32, device=leaf.device)
            continue
        x = leaf.float()
        amax = x.abs().amax(dim=tuple(range(x.dim() - 1)))
        scale = (amax * _INV127 if compiled else _divide(amax, 127.0)).clamp_min(1e-12)
        q[key] = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
        s[key] = scale
    return {"q": q, "s": s}


def quantize_decode_params(params, module):
    """One-shot weight-only int8 of ``params`` (``module``'s state dict), as
    the JAX package's ``quantize_decode_params`` quantizes the same weights:
    in the JAX tree's layout (``convert.params_to_jax`` /
    ``lm_head_params_to_jax`` on the device), one scale a last-axis channel
    of each eligible leaf. Returns ``{"q": {flax key: tensor}, "s": {flax
    key: fp32 scale}}``."""
    to_jax, _ = _jax_layout(module)
    return _quantize_flat(to_jax(params), compiled=False)


def dequantize_decode_params(qparams, module, dtype=None):
    """Invert ``quantize_decode_params`` into ``module``'s state dict: int8
    leaves dequantize per channel to ``dtype`` (default fp32); the others
    return unchanged."""
    _, from_jax = _jax_layout(module)
    tgt = dtype or torch.float32
    flat = {key: (q.float() * qparams["s"][key]).to(tgt) if q.dtype == torch.int8 else q
            for key, q in qparams["q"].items()}
    return from_jax(flat)


def fake_quant_decode_params(params, module):
    """``smp.generate``'s side of ``SMP_DECODE_WEIGHTS=int8``: every eligible
    weight round-trips through the int8 grid (quantize, then dequantize to
    its own dtype), as the JAX package's generate program does, so generate
    and the serving engine run on the same values under the knob."""
    to_jax, from_jax = _jax_layout(module)
    flat = to_jax(params)
    qp = _quantize_flat(flat, compiled=True)
    return from_jax({key: (q.float() * qp["s"][key]).to(flat[key].dtype) if q.dtype == torch.int8 else flat[key]
                     for key, q in qp["q"].items()})


# ----------------------------------------------------------------------
# Serving: int8 paged KV (per-block, per-head scales)
# ----------------------------------------------------------------------


def kv_pool_dtype(requested):
    """The pools' dtype: int8 under ``SMP_KV_QUANT=int8``, else
    ``requested``."""
    return torch.int8 if kv_quant_mode() == "int8" else requested


def kv_quantize_append(pool_i8, scale, k, blk_flat):
    """One paged append under int8, as the JAX engine's compiled program
    does it: fold the incoming tokens' per-head amax / 127 into the touched
    blocks' scales (a scatter-max: scales only grow; at least 1e-12),
    requantize the pool by ``old / new`` (exact where a scale did not move),
    and quantize the new tokens last, on the grown scales, clipped to
    +-127.

    Args:
      pool_i8: [nb, bt, H, hd] int8 pool.
      scale: [nb, H] fp32 scales.
      k: [N, H, hd] incoming tokens.
      blk_flat: [N] destination block of each token.
    Returns (requantized pool, new scale, tokens int8 [N, H, hd]).
    """
    tok_amax = k.float().abs().amax(dim=2)                                       # [N, H]
    idx = blk_flat.long()[:, None].expand_as(tok_amax)
    grown = scale.scatter_reduce(0, idx, tok_amax * _INV127, reduce="amax")
    new_scale = grown.clamp_min(1e-12)
    ratio = scale / new_scale                                                    # <= 1
    requant = torch.round(pool_i8.float() * ratio[:, None, :, None]).to(torch.int8)
    d = new_scale[blk_flat.long()]                                               # [N, H]
    q_tok = torch.round(k.float() / d[:, :, None]).clamp_(-127, 127).to(torch.int8)
    return requant, new_scale, q_tok


def kv_dequantize_gather(vals_i8, scale, slot_blocks, dtype):
    """Dequantize gathered KV columns: ``vals_i8`` [B, S, H, hd] int8,
    ``slot_blocks`` [B, S] the pool block of each column."""
    d = scale[slot_blocks.long()]                                                # [B, S, H]
    return (vals_i8.float() * d[..., None]).to(dtype)
