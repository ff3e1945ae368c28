"""Context parallelism: ring attention and Ulysses over the cp group.

Counterpart of ``smdistributed_modelparallel_tpu/ops/context_parallel.py``.
The JAX package runs its bodies inside a ``shard_map`` over the ``cp`` mesh
axis; here every cp rank is a process that holds its contiguous sequence
shard [B, Tl, H, hd] (the step slices it, ``step.py``), and the bodies talk
over the rank's cp ``TensorGroup`` (``backend/collectives.py``).

- **Ring** (``context_parallel_impl: ring``, the default): a
  ``torch.autograd.Function`` following the JAX package's ``_ring_flash_fn``.
  For causal attention the shards are re-laid in zigzag order (rank i holds
  half-chunks i and 2n-1-i; two ppermutes each way) so every rank carries an
  equal share of the causal triangle. The forward runs one ids-mode flash
  call per ring step (``flash_fwd_with_ids``: the global row and column ids
  drive the causal mask, dropout hashes them with the ``counter_len = Tl * n``
  stride) and merges the fp32 partials online (``_merge_partial``). The
  backward feeds every step the global lse (the masked sentinel mapped back
  to 1e30) and delta: dq accumulates on the rank, while the dk/dv
  accumulators rotate with k/v, so each block's gradient is home after the
  full cycle. The key-padding bias rides the ring with k/v.
- **Ulysses** (``ulysses``): two all-to-alls re-shard [B, Tl, H, hd] ->
  [B, T, H/cp, hd] (heads scattered, sequence gathered), the flash kernel of
  rows 1-3 runs on the whole sequence with the global head coordinates
  (``head0 = rank * H/cp``, ``head_total = H``, ``counter_len = T``), and a
  third all-to-all shards back. The key-padding bias is all-gathered.
- **allgather** is not ported: it raises ``NotImplementedError``.

Chunking (a decision, not an omission). The JAX package splits a block longer
than ``_RING_CHUNK`` (8192) into ``n_sub`` kernel calls, and pads odd
lengths to a chunkable one (``_ring_chunks``, ``_pad_plan``), because its
kernels hold whole K/V blocks in the TPU's VMEM. The CUDA kernels stream
64-row tiles through shared memory and take any length, so the port always
calls them unchunked (``n_sub = 1``, no padding). The results agree with the
chunked JAX path to fp32 rounding: the chunks merge with the same online
rule, and the backward's chunk contributions are additive.

Both bodies hash dropout on global (b*H + h, row, col) ids, so ring and
Ulysses drop the same probabilities, as in the JAX package.
"""

import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
    LSE_MASKED,
    attention_delta,
    flash_attention,
    flash_bwd_dkv_ids,
    flash_bwd_dq_ids,
    flash_fwd_with_ids,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

NEG_INF = -1e30


def _tr(a):
    """[B, H, T] per-row weight -> broadcastable over [B, T, H, hd]."""
    return a.permute(0, 2, 1)[..., None]


def _merge_partial(u, m_run, z, o_i, lse_i):
    """One online-softmax merge step for blockwise flash partials (the JAX
    package's, comparisons in fp32 as there). ``lse_i`` carries the kernels'
    1e30 sentinel for rows with nothing visited."""
    lse_i = torch.where(lse_i > 1e29, NEG_INF, lse_i)
    m_new = torch.maximum(m_run, lse_i)
    m_safe = torch.clamp(m_new, min=-1e29)
    alpha = torch.where(m_run > NEG_INF / 2, torch.exp(m_run - m_safe), 0.0)
    w_i = torch.where(lse_i > NEG_INF / 2, torch.exp(lse_i - m_safe), 0.0)
    u = u * _tr(alpha) + o_i.float() * _tr(w_i)
    z = z * alpha + w_i
    return u, m_new, z


def _finalize_merge(u, m_run, z, dtype):
    """(normalized output, global lse with NEG_INF on all-masked rows)."""
    out = (u / _tr(torch.clamp(z, min=1e-30))).to(dtype)
    lse = torch.where(z > 0.0, torch.clamp(m_run, min=-1e29) + torch.log(torch.clamp(z, min=1e-30)), NEG_INF)
    return out, lse


def _zig_rows(dev, half, n, device=None):
    """Global row indices of the zigzag-local block held by ``dev``."""
    a = dev * half + torch.arange(half, device=device)
    b = (2 * n - 1 - dev) * half + torch.arange(half, device=device)
    return torch.cat([a, b])


def _zig_owner(h, n):
    """Zigzag owner of half-chunk h (of 2n): rank h for the first n
    half-chunks, mirrored back for the rest."""
    return h if h < n else 2 * n - 1 - h


def _zig_perms(n):
    """The two rank permutations of the natural -> zigzag re-layout: rank
    d's first half goes to the owner of half-chunk 2d, its second half to
    the owner of 2d+1."""
    perm1 = [(d, _zig_owner(2 * d, n)) for d in range(n)]
    perm2 = [(d, _zig_owner(2 * d + 1, n)) for d in range(n)]
    return perm1, perm2


def _zig_enter(xs, me, n, group):
    """Natural-layout local blocks [B, Tl, ...] -> zigzag-layout blocks."""
    half = xs[0].shape[1] // 2
    perm1, perm2 = _zig_perms(n)
    a = group.ppermute([x[:, :half] for x in xs], perm1)
    b = group.ppermute([x[:, half:] for x in xs], perm2)
    # Slot 0 holds half-chunk me (a first half iff me is even), slot 1
    # half-chunk 2n-1-me.
    even = me % 2 == 0
    return [torch.cat([ai, bi] if even else [bi, ai], dim=1) for ai, bi in zip(a, b)]


def _zig_exit(xs, me, n, group):
    """Zigzag-layout local blocks -> natural layout (inverse of enter)."""
    half = xs[0].shape[1] // 2
    perm1, perm2 = _zig_perms(n)
    inv1 = [(dst, src) for src, dst in perm1]
    inv2 = [(dst, src) for src, dst in perm2]
    even = me % 2 == 0
    first = group.ppermute([x[:, :half] if even else x[:, half:] for x in xs], inv1)   # h even
    second = group.ppermute([x[:, half:] if even else x[:, :half] for x in xs], inv2)  # h odd
    return [torch.cat([f, s], dim=1) for f, s in zip(first, second)]


def _rows_for(dev, Tl, n, zigzag, device):
    if zigzag:
        return _zig_rows(dev, Tl // 2, n, device)
    return dev * Tl + torch.arange(Tl, device=device)


class _RingFlashFn(torch.autograd.Function):
    """Ring attention over the cp group on the ids-mode flash kernels
    (``_ring_flash_fn``): saves only the local (zigzag-layout) q, k, v, kpad,
    output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, kp, seed, group, scale, causal, zigzag, dropout_rate):
        n, me = group.size, group.index
        if zigzag:
            q, k, v, *rest = _zig_enter([q, k, v] + ([kp] if kp is not None else []), me, n, group)
            kp = rest[0] if rest else None
        B, Tl, H, hd = q.shape
        rows_g = _rows_for(me, Tl, n, zigzag, q.device)
        kw = dict(scale=scale, causal=causal, seed=seed if dropout_rate > 0.0 else None,
                  dropout_rate=dropout_rate, counter_len=Tl * n)
        perm = [(i, (i + 1) % n) for i in range(n)]
        u = torch.zeros((B, Tl, H, hd), dtype=torch.float32, device=q.device)
        m_run = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
        z = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
        k_cur, v_cur, kp_cur = k, v, kp
        for i in range(n):
            cols = _rows_for((me - i) % n, Tl, n, zigzag, q.device)
            o_i, lse_i = flash_fwd_with_ids(q, k_cur, v_cur, kp_cur, rows_g, cols, **kw)
            u, m_run, z = _merge_partial(u, m_run, z, o_i, lse_i)
            if i < n - 1:
                k_cur, v_cur, *rest = group.ppermute([k_cur, v_cur] + ([kp_cur] if kp is not None else []), perm)
                kp_cur = rest[0] if rest else None
        out, lse = _finalize_merge(u, m_run, z, q.dtype)
        ctx.save_for_backward(q, k, v, kp, out, lse)
        ctx.group, ctx.zigzag, ctx.kw = group, zigzag, kw
        return _zig_exit([out], me, n, group)[0] if zigzag else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, kp, o, lse = ctx.saved_tensors
        group, zigzag, kw = ctx.group, ctx.zigzag, ctx.kw
        n, me = group.size, group.index
        if zigzag:
            g = _zig_enter([g], me, n, group)[0]
        g = g.to(q.dtype).contiguous()
        B, Tl, H, hd = q.shape
        rows_g = _rows_for(me, Tl, n, zigzag, q.device)
        lse_b = torch.where(lse <= NEG_INF / 2, LSE_MASKED, lse)
        delta = attention_delta(o, g)
        perm = [(i, (i + 1) % n) for i in range(n)]
        dq = torch.zeros((B, Tl, H, hd), dtype=torch.float32, device=q.device)
        dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
        k_cur, v_cur, kp_cur = k, v, kp
        for i in range(n):
            cols = _rows_for((me - i) % n, Tl, n, zigzag, q.device)
            dq += flash_bwd_dq_ids(q, k_cur, v_cur, g, lse_b, delta, kp_cur, rows_g, cols, **kw)
            dk_i, dv_i = flash_bwd_dkv_ids(q, k_cur, v_cur, g, lse_b, delta, kp_cur, rows_g, cols, **kw)
            dk += dk_i
            dv += dv_i
            # dk/dv ride the ring with k/v: after the full cycle each block's
            # accumulated gradient sits on its owner.
            if i < n - 1:
                k_cur, v_cur, *rest = group.ppermute([k_cur, v_cur] + ([kp_cur] if kp is not None else []), perm)
                kp_cur = rest[0] if rest else None
            dk, dv = group.ppermute([dk, dv], perm)
        if zigzag:
            dq, dk, dv = _zig_exit([dq, dk, dv], me, n, group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all`` (tiled) over a group, differentiable: the
    backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.group.all_to_all(g.contiguous(), concat_dim, split_dim), None, None, None


def ring_attention(q, k, v, kpad, seed, *, scale, causal, dropout_rate, group):
    """Ring attention over the local shards [B, Tl, H, hd] of ``group``'s
    ranks (``ring_attention_local_flash`` at n_sub = 1)."""
    rate = float(dropout_rate) if seed is not None else 0.0
    zigzag = bool(causal) and q.shape[1] % 2 == 0 and group.size > 1
    return _RingFlashFn.apply(q, k, v, kpad, seed, group, float(scale), bool(causal), zigzag, rate)


def ulysses_attention(q, k, v, kpad, seed, *, scale, causal, dropout_rate, group):
    """Ulysses attention over the local shards (``ulysses_attention_local``
    with its flash kernel at n_sub = 1)."""
    n, H = group.size, q.shape[2]
    if H % n != 0:
        raise SMPValidationError(f"Ulysses context parallelism needs heads ({H}) divisible by cp degree ({n}).")
    qg, kg, vg = (_AllToAll.apply(x, group, 2, 1) for x in (q, k, v))  # [B, T, H/cp, hd]
    T = qg.shape[1]
    kp_full = group.all_gather(kpad, dim=1) if kpad is not None else None
    use_drop = dropout_rate > 0.0 and seed is not None
    out, _ = flash_attention(
        qg, kg, vg, kp_full, seed=seed if use_drop else None,
        head0=group.index * qg.shape[2] if use_drop else None, scale=scale, causal=causal,
        dropout_rate=dropout_rate if use_drop else 0.0, block_q=256, block_k=256, head_total=H,
        counter_len=T,
    )
    return _AllToAll.apply(out.to(q.dtype), group, 1, 2)


def cp_attention(q, k, v, *, scale, causal, impl=None, kpad=None, dropout_rate=0.0, seed=None, group=None):
    """Context-parallel attention over this rank's sequence shard:
    q, k, v [B, Tl, H, hd] (natural, contiguous layout), ``kpad`` an
    additive fp32 key-padding bias [B, Tl] of the same shard, ``seed`` an
    int enabling dropout at ``dropout_rate``. ``group``: the cp group (by
    default this rank's). Returns [B, Tl, H, hd] in q's dtype."""
    group = group or state.group(CP_AXIS)
    if group is None:
        raise SMPValidationError("cp_attention needs a context-parallel group (context_parallel_degree > 1).")
    impl = impl or state.cfg.context_parallel_impl
    if dropout_rate > 0.0 and seed is None:
        dropout_rate = 0.0
    kpad = kpad.float() if kpad is not None else None
    kw = dict(scale=scale, causal=causal, dropout_rate=dropout_rate, group=group)
    if impl == "ring":
        return ring_attention(q, k, v, kpad, seed, **kw)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, kpad, seed, **kw)
    if impl == "allgather":
        raise NotImplementedError(
            "context_parallel_impl: allgather (K/V gathered by GSPMD in the JAX package) is not ported to "
            "PyTorch yet (a later context-parallel slice); use ring or ulysses."
        )
    raise SMPValidationError(f"Unknown context_parallel_impl {impl!r}")
