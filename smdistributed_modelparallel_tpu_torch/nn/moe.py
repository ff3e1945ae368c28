"""Mixture-of-Experts: ``DistributedMoE``, ``collect_moe_aux`` and
``moe_aux_losses``.

Counterpart of ``smdistributed_modelparallel_tpu/nn/moe.py``. The body is the
JAX package's dense-dispatch formulation, step for step:

- the router in fp32 (``x.float() @ router.kernel``; in training,
  ``router_jitter`` > 0 scales the logits by ``uniform[1 - j, 1 + j)`` drawn
  from the module's dropout key), a softmax, and the top ``top_k`` experts a
  token, ties going to the lower expert index as ``jax.lax.top_k`` breaks
  them (a stable descending sort: ``torch.topk`` breaks them otherwise),
  renormalized to a convex mixture only for k > 1 (Switch top-1 scales by
  the raw gate);
- a fixed capacity ``C = max(k, ceil(k * N * capacity_factor / E))`` a
  expert; each assignment's slot is its position in the expert, counted
  k-major (every first choice before any second choice) in int32, and
  assignments past C are dropped (the token falls through the residual);
- the Switch load-balancing loss ``E * sum(frac_routed * mean_gate)`` times
  ``aux_loss_coef``, "sown": kept as the module's ``intermediates``
  (``{"moe_aux_loss": (aux,)}``, the last forward's) and, inside an
  ``@smp.step``, recorded on the model being called, which adds the
  microbatch's sum to the differentiated loss at ``moe_aux_loss_weight``
  (``DistributedModel._end_microbatch``);
- the expert FFNs as batched products over [E, C, D] (``torch.bmm``), the
  combine, and the hidden dropout at the flax scope ``output/Dropout_0``.

Global routing. The JAX package routes the *global* microbatch under jit: N
is every token of every data rank, the slot positions come from one cumsum
over all of them, and the aux takes global means. Inside a step whose
microbatch is spread over data ranks (rdp, ep or cp > 1: ``state.rdp_sharded``
or ``state.cp_sharded``) each rank routes its own tokens, then all-gathers
every data rank's ``expert_idx`` ([N_local, K] int32) over the data group
(``topology.DATA_AXES``) and lays them out in the JAX package's token order:
row-major over the microbatch, the rows sharded over (rdp, ep) in mesh order
and each row's sequence over cp in contiguous shards (the step's layout; the
ring's zigzag stays inside the attention). From the global choices every
rank computes the global capacity and the k-major positions exactly as the
JAX package does, and keeps its own tokens' slots. The aux becomes a sum over
the data ranks: ``frac_routed`` is the global top-1 fraction (a constant),
and the rank's ``mean_gate`` is its own gates' sum over the global N, so its
gradient reaches only the rank's gates and the ranks' auxes add up to the
JAX package's. ``DistributedModel._end_microbatch`` keeps the folded term
apart (``_aux_term``) so that the step weighs it by the data degree, not by
the rank's loss weight (``step.py``).

Expert parallelism (ep > 1). ``DistributedModel`` keeps the ep rank's experts
``[j*E/ep, (j+1)*E/ep)`` of ``fc`` and ``proj`` (``shard_experts``; a full
[E, ...] leaf loaded later is sliced the same way). Each rank builds its
partial ``expert_in`` [E, C, D], in which only its own tokens' slots are
nonzero. An all-to-all over the ep group and a sum over the pieces received
(a reduce-scatter along E) give the ep rank its experts' [E/ep, C, D]; the
FFNs run on them; an all-to-all back (an all-gather along E) gives every rank
``y`` [E, C, D] for its combine. Each exchange's backward is its transpose
(``backend.collectives.all_to_all``). A slot holds one token globally, so the
sums add exact zeros. The FFN acts on each slot's row alone, so the ranks
that hold the same experts in other rdp or cp coordinates need none of this
ep group's rows: the exchange stays within the ep group, and nothing is
summed over rdp x cp in the forward (the expert gradients are, in the step).
At ep > 1 the module runs inside an ``@smp.step`` only (ROADMAP item 5b: a
bare call, ``smp.generate`` and the serving engine are refused).

The one-hot einsums and the expert products are plain products that the JAX
package leaves to XLA too, outside any Pallas kernel.

Parameters keep the JAX names and shapes as ``kernel``/``bias`` tensors of
three holder modules: ``router.kernel`` [D, E] (fp32), ``fc.kernel`` [E, D,
F], ``fc.bias`` [E, F], ``proj.kernel`` [E, F, D] and ``proj.bias`` [E, D]
(E/ep rows on an ep rank), in ``dtype`` (default fp32, the dtype the JAX
package's init sees).
"""

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.collectives import all_to_all
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import DATA_AXES, EP_AXIS
from smdistributed_modelparallel_tpu_torch.nn.transformer import _ACTIVATIONS, _dropout, refuse_tp
from smdistributed_modelparallel_tpu_torch.nn.utils import make_rng, resolve_deterministic
from smdistributed_modelparallel_tpu_torch.ops import dropout as dropout_op
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


class _Leaves(nn.Module):
    """A holder of JAX-named parameter leaves (``kernel``, ``bias``)."""

    def __init__(self, **leaves):
        super().__init__()
        for name, value in leaves.items():
            setattr(self, name, nn.Parameter(value))


def _one_hot(idx, n):
    """``jax.nn.one_hot(idx, n)`` as fp32: an index outside [0, n) gives a
    row of zeros (``F.one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class DistributedMoE(nn.Module):
    """Top-k routed mixture of expert FFNs, a drop-in for the transformer
    MLP, with the JAX module's fields as keyword arguments."""

    def __init__(self, hidden_size, intermediate_size, num_experts, top_k=2, capacity_factor=1.25,
                 activation="gelu", hidden_dropout_prob=0.0, initializer_range=0.02, router_jitter=0.0,
                 aux_loss_coef=0.01, deterministic=None, dtype=None, device=None):
        super().__init__()
        if top_k < 1 or top_k > num_experts:
            raise SMPValidationError(f"moe top_k ({top_k}) must be in [1, num_experts={num_experts}].")
        D, F, E = hidden_size, intermediate_size, num_experts
        self.hidden_size, self.intermediate_size, self.num_experts = D, F, E
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.hidden_dropout_prob = hidden_dropout_prob
        self.initializer_range = initializer_range
        self.router_jitter = router_jitter
        self.aux_loss_coef = aux_loss_coef
        self.deterministic = deterministic
        self.intermediates = {}
        kw = dict(dtype=dtype or torch.float32, device=device)
        self.router = _Leaves(kernel=torch.empty(D, E, dtype=torch.float32, device=device))
        self.fc = _Leaves(kernel=torch.empty(E, D, F, **kw), bias=torch.empty(E, F, **kw))
        self.proj = _Leaves(kernel=torch.empty(E, F, D, **kw), bias=torch.empty(E, D, **kw))
        self.expert_range = (0, E)  # the experts this rank holds (shard_experts)
        self.reset_parameters()
        self.register_load_state_dict_pre_hook(_slice_full_experts)

    @torch.no_grad()
    def shard_experts(self, size, index):
        """Keep experts ``[index*E/size, (index+1)*E/size)`` of ``fc`` and
        ``proj``: ep rank ``index`` of ``size``. A module sharded already is
        left as it is."""
        E = self.num_experts
        if size == 1 or self.expert_range != (0, E):
            return
        if E % size:
            raise SMPValidationError(
                f"num_experts ({E}) must be divisible by expert_parallel_degree ({size}) so experts shard evenly "
                "over the ep mesh axis."
            )
        lo, hi = index * E // size, (index + 1) * E // size
        for leaves in (self.fc, self.proj):
            for name in ("kernel", "bias"):
                setattr(leaves, name, nn.Parameter(getattr(leaves, name)[lo:hi].clone()))
        self.expert_range = (lo, hi)

    def expert_parameter_names(self):
        """The names (in this module) of the parameters an ep rank holds a
        slice of."""
        return [f"{h}.{n}" for h in ("fc", "proj") for n in ("kernel", "bias")]

    @torch.no_grad()
    def reset_parameters(self, std=None, generator=None):
        """The JAX initializers: normal(0, ``std``) kernels (default
        ``initializer_range``), zero biases; from ``generator``."""
        std = self.initializer_range if std is None else std
        for leaves in (self.router, self.fc, self.proj):
            if leaves.kernel.is_meta:
                continue
            leaves.kernel.normal_(0.0, std, generator=generator)
            if hasattr(leaves, "bias"):
                leaves.bias.zero_()

    def _check_ep(self):
        ep = state.cfg.expert_parallel_degree if state.cfg is not None else 1
        if ep > 1 and self.num_experts % ep != 0:
            raise SMPValidationError(
                f"num_experts ({self.num_experts}) must be divisible by expert_parallel_degree ({ep}) so experts "
                "shard evenly over the ep mesh axis."
            )

    def _sow(self, aux):
        self.intermediates = {"moe_aux_loss": (aux,)}
        model = state.calling_model
        if model is not None:
            model._sow_moe_aux(aux)

    def _exchange_groups(self):
        """``(data group, ep group)`` of this forward: the data group when a
        step spreads the microbatch over data ranks (global routing), the ep
        group when this rank holds a slice of the experts."""
        sharded = self.expert_range != (0, self.num_experts)
        inside = state.rdp_sharded or state.cp_sharded
        if sharded and not inside:
            raise NotImplementedError(
                "DistributedMoE at expert_parallel_degree > 1 runs inside an @smp.step only: a bare model call, "
                "smp.generate and the serving engine are not ported to PyTorch at ep > 1 yet (ROADMAP item 5b)."
            )
        return (state.group(DATA_AXES) if inside else None), (state.group(EP_AXIS) if sharded else None)

    def _global_choices(self, expert_idx, B, T, group):
        """Every data rank's choices [N_global, K] in the JAX package's token
        order, and this rank's (row block, sequence shard) in it."""
        K = self.top_k
        cp = state.topology.cp_size if state.cp_sharded else 1
        rows = group.size // cp
        got = group.all_gather(expert_idx.to(torch.int32).reshape(1, B, T, K), dim=0)  # [G, B, T, K]
        got = got.reshape(rows, cp, B, T, K).permute(0, 2, 1, 3, 4).reshape(rows * B * cp * T, K)
        return got, divmod(group.index, cp), cp

    def forward(self, hidden):
        refuse_tp("DistributedMoE (its F axis over tp)")
        self._check_ep()
        D, E, K = self.hidden_size, self.num_experts, self.top_k
        B, T = hidden.shape[:2]
        N = B * T
        x = hidden.reshape(N, D)
        group, ep_group = self._exchange_groups()

        # The router, in fp32 for a stable softmax.
        logits = x.float() @ self.router.kernel.float()
        if self.router_jitter > 0.0 and not resolve_deterministic(self.deterministic):
            noise = dropout_op.uniform(make_rng(self, "dropout"), logits.shape, logits.device,
                                       minval=1.0 - self.router_jitter, maxval=1.0 + self.router_jitter)
            logits = logits * noise
        gates = torch.softmax(logits, dim=-1)                                 # [N, E]
        vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)  # jax.lax.top_k's tie order
        gate_vals, expert_idx = vals[:, :K], idx[:, :K]                       # [N, K]
        if K > 1:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

        # The choices the capacity and the slots are counted over: this
        # rank's, or every data rank's in the JAX package's token order.
        if group is None:
            idx_all, n_all = expert_idx, N
        else:
            idx_all, (block, shard), cp = self._global_choices(expert_idx, B, T, group)
            n_all = idx_all.shape[0]
        capacity = int(max(K, -(-K * n_all * self.capacity_factor // E)))
        # Slot of each assignment in its expert, k-major then token-major, in
        # int32 as the JAX package counts it.
        sel_all = _one_hot(idx_all, E)                                        # [N_all, K, E]
        sel_i = sel_all.to(torch.int32)
        sel_km = sel_i.transpose(0, 1).reshape(K * n_all, E)
        pos_km = torch.cumsum(sel_km, dim=0, dtype=torch.int32) - sel_km
        pos = pos_km.reshape(K, n_all, E).transpose(0, 1)                     # [N_all, K, E]
        pos_k = (pos * sel_i).sum(dim=-1, dtype=torch.int32)                  # [N_all, K]
        if group is None:
            sel = sel_all
        else:
            # This rank's tokens: row block `block`, sequence shard `shard`.
            pos_k = pos_k.reshape(n_all // (T * cp), T * cp, K)[block * B:(block + 1) * B, shard * T:(shard + 1) * T]
            pos_k = pos_k.reshape(N, K)
            sel = _one_hot(expert_idx, E)
        keep = (pos_k < capacity).float()
        pos_oh = _one_hot(pos_k, capacity)                                    # [N, K, C]
        combine = torch.einsum("nk,nke,nkc->nec", gate_vals * keep, sel, pos_oh)
        dispatch = torch.einsum("nk,nke,nkc->nec", keep, sel, pos_oh)

        # Switch's load-balancing loss (eq. 4) on the first choices, over the
        # global microbatch: this rank's part of the JAX package's sum.
        frac_routed = sel_all[:, 0, :].mean(dim=0)
        mean_gate = gates.mean(dim=0) if group is None else gates.sum(dim=0) / n_all
        aux = (frac_routed * mean_gate).sum() * float(E)
        self._sow(aux * self.aux_loss_coef)

        # The expert FFNs, batched over the (local) expert axis.
        dt = hidden.dtype
        C = capacity
        expert_in = (dispatch.to(dt).reshape(N, E * C).t() @ x).reshape(E, C, D)
        if ep_group is not None:
            # Reduce-scatter along E: piece j goes to ep rank j, which sums
            # what every ep rank sent it (exact: one token a slot).
            n = ep_group.size
            expert_in = all_to_all(expert_in.reshape(n, E // n, C, D), ep_group, 0, 0).sum(dim=0)
        h = torch.bmm(expert_in, self.fc.kernel.to(dt))
        h = _ACTIVATIONS[self.activation](h + self.fc.bias[:, None].to(h.dtype))
        y = torch.bmm(h, self.proj.kernel.to(h.dtype))
        y = y + self.proj.bias[:, None].to(y.dtype)
        if ep_group is not None:
            # All-gather along E: every rank gets every expert's outputs.
            y = all_to_all(y.expand(ep_group.size, *y.shape), ep_group, 0, 0).reshape(E, C, D)
        out = (combine.to(y.dtype).reshape(N, E * C) @ y.reshape(E * C, D)).reshape(B, T, D)
        return _dropout(self, out, self.hidden_dropout_prob)


def _slice_full_experts(module, state_dict, prefix, *args):
    """Load hook: a full [E, ...] expert leaf loads into an ep rank's slice
    (``convert.shard_experts``)."""
    from smdistributed_modelparallel_tpu_torch.convert import shard_experts

    if module.expert_range == (0, module.num_experts):
        return
    names = [prefix + n for n in module.expert_parameter_names()]
    state_dict.update(shard_experts({k: state_dict[k] for k in names if k in state_dict},
                                    module.num_experts, module.expert_range))


def _walk(tree, under_aux=False):
    """The tensors of ``tree`` (nested dicts, lists and tuples) that sit
    under a ``moe_aux_loss`` key."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _walk(value, under_aux or key == "moe_aux_loss")
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _walk(value, under_aux)
    elif under_aux and tree is not None:
        yield torch.as_tensor(tree)


def _intermediates_of(module):
    """``{module path: intermediates}`` of every ``DistributedMoE`` in
    ``module``: what its last forward sowed."""
    return {name: m.intermediates for name, m in module.named_modules() if isinstance(m, DistributedMoE)}


def collect_moe_aux(intermediates):
    """The sum of every ``moe_aux_loss`` in an intermediates tree (nested
    dicts, lists and tuples of tensors), or in a module (the last forward's
    of each ``DistributedMoE`` in it); None when nothing was sown, so a
    model without experts adds no term."""
    if isinstance(intermediates, nn.Module):
        intermediates = _intermediates_of(intermediates)
    if not intermediates:
        return None
    total = None
    for leaf in _walk(intermediates):
        s = leaf.sum()
        total = s if total is None else total + s
    return total


def moe_aux_losses(intermediates):
    """The sum of every ``moe_aux_loss`` sown anywhere in an intermediates
    tree or module (0.0 when none), for a caller reading aux losses itself;
    ``DistributedModel`` inside an ``@smp.step`` folds them into the
    differentiated loss already (weighted by ``moe_aux_loss_weight``)."""
    total = collect_moe_aux(intermediates)
    return 0.0 if total is None else total


__all__ = ["DistributedMoE", "collect_moe_aux", "moe_aux_losses"]
