"""Ring-decomposed collective matmuls: overlapped tensor parallelism.

Counterpart of ``smdistributed_modelparallel_tpu/ops/collective_matmul.py``.
At tp > 1 the ``smp.nn`` layers gather the sequence before a
column-parallel product and reduce after a row-parallel one
(``backend/collectives.py``'s tp regions); the product waits for the gather
and the reduction for the product. ``tp_overlap: "ring"`` (env alias
``SMP_TP_OVERLAP``) decomposes each of those collectives into tp - 1 hops
between ring neighbours, each hop posted (``TensorGroup.ppermute_start``)
before the partial product it should hide under, as the JAX package pins it
with ``_issue_before``:

- ``ring_ag_matmul``: column-parallel ``allgather_seq(x) @ W^T (+ b)`` with
  W the rank's output rows. The ring rotates x's sequence blocks; the block
  that rank r holds at step s is the block of rank (r - s) mod tp, and its
  product lands at that block's T positions. With ``fused`` the partial
  products (the bias folded in) are ``ops/matmul_bias``'s kernel, one launch
  a chunk: the JAX package's ``_chunk_mm`` through ``pallas_qkv.matmul_bias``.
  Backward: x's blocks rotate again for dW while an fp32 accumulator ring
  reduce-scatters dx, both hops posted together;
- ``ring_rs_matmul``: row-parallel ``reduce_scatter_seq(x @ W^T)`` with x
  sharded on the contraction dim. The accumulator rotates: at step s it
  holds the partial sums of block (r - s - 1) mod tp and gains this rank's
  partial for it (in x's dtype, the received sum first); after the last step
  it holds the rank's own block. The row-parallel bias is not folded: the
  caller adds it once, after the ring. Backward: dy's blocks rotate; each
  gives dx for its block and its part of dW.

Each ring is a ``torch.autograd.Function`` with the mirrored backward
written out: no autograd runs through a point-to-point call. The JAX ring
issues tp hops and drops the last; the port issues the tp - 1 the ring
needs, with the same values. Under ``matmul_precision: fp8`` both operands
round to the e4m3 grid at the ring's boundary (``quant.fake_quant``, slots
``ring_ag.*`` / ``ring_rs.*``, one ``smp_quant_dispatch_total`` note each);
the partial products and the backward stay as built.

A layer decides once per call whether it takes the ring
(``ring_applies``): where tp does not divide the sequence the ring cannot
apply, the decision warns once and the layer keeps its non-ring path, as
the JAX package falls back to GSPMD. The layers already require tp to divide the
sharded features (heads, MLP width), so that check of the JAX package's has
nothing left to refuse here.
"""

import torch
import torch.nn.functional as F

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.collectives import gather_from_tp, scatter_to_tp
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

# One warning per distinct (reason, detail) when the ring is asked for but
# cannot engage and the layer keeps its non-ring path.
_FALLBACK_WARNED = set()


def _warn_once(key, msg, *args):
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    logger.warning(msg, *args)


def tp_overlap_mode(cfg=None):
    """The effective tp_overlap mode: the config's, read as "off" wherever
    it cannot change the program (tp degree 1; cp > 1, where the ring would
    own the sequence axis that cp shards)."""
    cfg = cfg if cfg is not None else state.cfg
    if cfg is None:
        return "off"
    mode = getattr(cfg, "tp_overlap", "off") or "off"
    if mode == "off" or getattr(cfg, "tensor_parallel_degree", 1) <= 1:
        return "off"
    if getattr(cfg, "context_parallel_degree", 1) > 1:
        _warn_once(("cp", mode),
                   "tp_overlap=%s requested with context_parallel_degree > 1; the ring owns the sequence axis and does "
                   "not compose with cp: keeping the non-ring tp path.", mode)
        return "off"
    return mode


def fused_qkv_effective(cfg=None):
    """The config's ``fused_qkv``, read as False wherever the config alone
    shows that it cannot engage: ``use_pallas_kernels`` off, or tp > 1
    without the ring (the non-ring tp path keeps the plain product)."""
    cfg = cfg if cfg is not None else state.cfg
    if cfg is None or not bool(getattr(cfg, "fused_qkv", False)):
        return False
    if not bool(getattr(cfg, "use_pallas_kernels", True)):
        return False
    return getattr(cfg, "tensor_parallel_degree", 1) <= 1 or tp_overlap_mode(cfg) == "ring"


def tp_overlap_active():
    """Whether the tp layers take the ring now: the mode resolves to "ring"
    and ``smp.init`` built a tp group of more than one rank."""
    if tp_overlap_mode() != "ring":
        return False
    return _group() is not None


def _group():
    from smdistributed_modelparallel_tpu_torch.nn.utils import tp_group

    return tp_group()


def _perm(tp):
    return [(i, (i + 1) % tp) for i in range(tp)]


def _chunk_mm(a, w, bias, fused):
    """One partial product of the ring: ``a @ w^T (+ bias)`` in a's dtype, w
    an ``nn.Linear``-style [F, D] weight. ``fused``: ``ops/matmul_bias``'s
    kernel on the card (its plain version on the CPU), the bias in its
    epilogue."""
    if fused:
        from smdistributed_modelparallel_tpu_torch.ops.matmul_bias import matmul_bias_fwd

        out = matmul_bias_fwd(a.reshape(-1, a.shape[-1]), w, bias)
        return out.reshape(a.shape[:-1] + (w.shape[0],))
    out = F.linear(a, w)
    return out if bias is None else out + bias


def _maybe_fp8_operands(x, w, site, call):
    """The ring's fp8 seam: both operands on the e4m3 grid with the site's
    delayed scales (straight-through gradient), one dispatch note for the
    call site ``call``; the identity outside an fp8 step."""
    if not quant.fp8_trace_active():
        return x, w
    from smdistributed_modelparallel_tpu_torch.nn.utils import program_tick

    program_tick("quant", site, "fp8", call=call)
    return quant.fake_quant(x, site + ".x"), quant.fake_quant(w, site + ".w")


class _RingAG(torch.autograd.Function):
    """``allgather_seq(x) @ w^T (+ b)``: x [*lead, Sl, D] this rank's
    sequence block, w [Fl, D], b [Fl] or None; out [*lead, tp * Sl, Fl]."""

    @staticmethod
    def forward(ctx, x, w, b, group, fused):
        tp, me = group.size, group.index
        chunks, x_cur = [None] * tp, x.contiguous()
        for i in range(tp):
            hop = group.ppermute_start(x_cur, _perm(tp)) if i < tp - 1 else None
            chunks[(me - i) % tp] = _chunk_mm(x_cur, w, b, fused)
            if hop is not None:
                x_cur = hop.wait()
        ctx.save_for_backward(x, w)
        ctx.group, ctx.has_bias = group, b is not None
        return torch.cat(chunks, dim=-2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        group = ctx.group
        tp, me = group.size, group.index
        Sl, D, Fl = x.shape[-2], x.shape[-1], w.shape[0]
        dy = dy.contiguous()

        def block(c):
            return dy.narrow(-2, c * Sl, Sl)

        dw = torch.zeros((Fl, D), dtype=torch.float32, device=w.device)
        x_cur, dacc = x.contiguous(), None
        for i in range(tp):
            # Post both hops (x onward for dW, the dx accumulator onward for
            # its next owner) before this step's products.
            send = ([x_cur] if i < tp - 1 else []) + ([dacc] if dacc is not None else [])
            hop = group.ppermute_start(send, _perm(tp)) if send else None
            src = (me - i) % tp  # whose x block is in hand
            dw += block(src).reshape(-1, Fl).float().t() @ x_cur.reshape(-1, D).float()
            part = (block((me - i - 1) % tp) @ w).float()  # this rank's share of dx for the block in transit
            if hop is None:
                dacc = part
                continue
            got = hop.wait()
            if dacc is not None:
                dacc = got[-1] + part
            else:
                dacc = part
            if i < tp - 1:
                x_cur = got[0]
        db = dy.float().sum(dim=tuple(range(dy.dim() - 1))).to(dy.dtype) if ctx.has_bias else None
        return dacc.to(x.dtype), dw.to(w.dtype), db, None, None


class _RingRS(torch.autograd.Function):
    """``reduce_scatter_seq(x @ w^T)``: x [*lead, S, Kl] (the contraction dim
    sharded), w [Do, Kl]; out [*lead, S / tp, Do], this rank's block."""

    @staticmethod
    def forward(ctx, x, w, group):
        tp, me = group.size, group.index
        Sl = x.shape[-2] // tp

        def part(i):
            return F.linear(x.narrow(-2, ((me - i - 1) % tp) * Sl, Sl), w)

        acc = part(0)
        for i in range(1, tp):
            hop = group.ppermute_start(acc, _perm(tp))
            p = part(i)
            acc = hop.wait() + p
        ctx.save_for_backward(x, w)
        ctx.group = group
        return acc

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        group = ctx.group
        tp, me = group.size, group.index
        Sl, K, Do = x.shape[-2] // tp, x.shape[-1], w.shape[0]
        dx, dw = [None] * tp, torch.zeros((Do, K), dtype=torch.float32, device=w.device)
        dy_cur = dy.contiguous()
        for i in range(tp):
            hop = group.ppermute_start(dy_cur, _perm(tp)) if i < tp - 1 else None
            src = (me - i) % tp  # whose dy block is in hand
            dx[src] = dy_cur @ w
            dw += dy_cur.reshape(-1, Do).float().t() @ x.narrow(-2, src * Sl, Sl).reshape(-1, K).float()
            if hop is not None:
                dy_cur = hop.wait()
        return torch.cat(dx, dim=-2).to(x.dtype), dw.to(w.dtype), None


def ring_applies(what, x, seq_sharded=False):
    """Whether a tp layer's product on ``x`` [*lead, T, D] (its rank's T
    block with ``seq_sharded``) takes the ring (``what``: "ag" or "rs"):
    ``tp_overlap_active`` and tp divides the sequence length; where it does
    not, one warning per (what, T, tp)."""
    if x.dim() < 2 or not tp_overlap_active():
        return False
    tp = _group().size
    T = x.shape[-2] * (tp if seq_sharded else 1)
    if T % tp:
        _warn_once((what, T, tp), "tp_overlap: sequence length %d not divisible by tp=%d: the non-ring tp path for "
                                  "this matmul.", T, tp)
        return False
    return True


def ring_ag_matmul(x, w, bias=None, *, seq_sharded=False, fused=False, call=None):
    """Column-parallel ``allgather_seq(x) @ w^T (+ bias)`` as a ring, where
    ``ring_applies("ag", x, seq_sharded)``. x [*lead, T, D]: replicated (the rank's T block enters the ring;
    backward: an all-gather of the blocks' gradients), or with
    ``seq_sharded`` this rank's block [*lead, T / tp, D]; w the rank's [Fl,
    D] rows and bias its [Fl]. Returns [*lead, T, Fl]. ``fused``: the chunk
    products through ``ops/matmul_bias``. ``call`` names the call site for
    the fp8 dispatch count (a layer's QKV and fc rings share the site)."""
    group = _group()
    seq_dim = x.dim() - 2
    x, w = _maybe_fp8_operands(x, w, "ring_ag", call)
    if not seq_sharded:
        x = scatter_to_tp(x, group, seq_dim)
    return _RingAG.apply(x, w, None if bias is None else bias.reshape(-1), group, bool(fused))


def ring_rs_matmul(x, w, *, seq_sharded=False, call=None):
    """Row-parallel ``reduce_scatter_seq(x @ w^T)`` as a ring, where
    ``ring_applies("rs", x)``. x [*lead, T, Kl] (the contraction dim
    this rank's block), w the rank's [Do, Kl] columns. Returns this rank's
    block [*lead, T / tp, Do] with ``seq_sharded``, else the whole [*lead, T,
    Do] (gathered; backward: the rank's chunk of the replicated gradient).
    The bias is the caller's, added once after the ring; ``call`` as for
    ``ring_ag_matmul``."""
    group = _group()
    seq_dim = x.dim() - 2
    x, w = _maybe_fp8_operands(x, w, "ring_rs", call)
    out = _RingRS.apply(x, w, group)
    return out if seq_sharded else gather_from_tp(out, group, seq_dim, split_grad=True)
