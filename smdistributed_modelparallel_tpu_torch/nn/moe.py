"""Mixture-of-Experts: ``DistributedMoE``, ``collect_moe_aux`` and
``moe_aux_losses``.

Counterpart of ``smdistributed_modelparallel_tpu/nn/moe.py`` at expert
degree 1, where every expert lives on the one device. The body is the JAX
package's dense-dispatch formulation, step for step:

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

The one-hot einsums and the expert products are plain products that the JAX
package leaves to XLA too, outside any Pallas kernel.

Parameters keep the JAX names and shapes as ``kernel``/``bias`` tensors of
three holder modules: ``router.kernel`` [D, E] (fp32), ``fc.kernel`` [E, D,
F], ``fc.bias`` [E, F], ``proj.kernel`` [E, F, D] and ``proj.bias`` [E, D],
in ``dtype`` (default fp32, the dtype the JAX package's init sees).
"""

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.transformer import _ACTIVATIONS, _check_tp, _dropout
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
        self.reset_parameters()

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

    def forward(self, hidden):
        _check_tp()
        self._check_ep()
        D, E, K = self.hidden_size, self.num_experts, self.top_k
        B, T = hidden.shape[:2]
        N = B * T
        x = hidden.reshape(N, D)

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

        capacity = int(max(K, -(-K * N * self.capacity_factor // E)))
        # Slot of each assignment in its expert, k-major then token-major, in
        # int32 as the JAX package counts it.
        sel = _one_hot(expert_idx, E)                                         # [N, K, E]
        sel_i = sel.to(torch.int32)
        sel_km = sel_i.transpose(0, 1).reshape(K * N, E)
        pos_km = torch.cumsum(sel_km, dim=0, dtype=torch.int32) - sel_km
        pos = pos_km.reshape(K, N, E).transpose(0, 1)                         # [N, K, E]
        pos_k = (pos * sel_i).sum(dim=-1, dtype=torch.int32)                  # [N, K]
        keep = (pos_k < capacity).float()
        pos_oh = _one_hot(pos_k, capacity)                                    # [N, K, C]
        combine = torch.einsum("nk,nke,nkc->nec", gate_vals * keep, sel, pos_oh)
        dispatch = torch.einsum("nk,nke,nkc->nec", keep, sel, pos_oh)

        # Switch's load-balancing loss (eq. 4) on the first choices.
        frac_routed = sel[:, 0, :].mean(dim=0)
        mean_gate = gates.mean(dim=0)
        aux = (frac_routed * mean_gate).sum() * float(E)
        self._sow(aux * self.aux_loss_coef)

        # The expert FFNs, batched over the expert axis.
        dt = hidden.dtype
        C = capacity
        expert_in = (dispatch.to(dt).reshape(N, E * C).t() @ x).reshape(E, C, D)
        h = torch.bmm(expert_in, self.fc.kernel.to(dt))
        h = _ACTIVATIONS[self.activation](h + self.fc.bias[:, None].to(h.dtype))
        y = torch.bmm(h, self.proj.kernel.to(h.dtype))
        y = y + self.proj.bias[:, None].to(y.dtype)
        out = (combine.to(y.dtype).reshape(N, E * C) @ y.reshape(E * C, D)).reshape(B, T, D)
        return _dropout(self, out, self.hidden_dropout_prob)


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
