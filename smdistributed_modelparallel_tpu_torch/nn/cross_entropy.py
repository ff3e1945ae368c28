"""Cross-entropy of the LM head.

Counterpart of ``smdistributed_modelparallel_tpu/nn/cross_entropy.py`` on
one device (no vocab sharding): the per-token ``vocab_parallel_cross_entropy``
(a stable log-softmax in fp32), its ``ignore_index`` form, the
``DistributedCrossEntropy`` module, and the tied-head
``fused_lm_head_cross_entropy`` with the same dispatch policy
(``_want_fused_ce``: config ``fused_ce`` True/False/"auto", the "auto"
threshold ``fused_ce_auto_threshold_mb`` on the logits at the activation
dtype, and the ``SMP_DISABLE_FUSED_CE=1`` escape hatch).

Where the policy wants the fused kernel and it can run (a CUDA tensor, the
escape hatch unset), the CE goes through ``ops/fused_ce.fused_lm_head_ce``:
the forward, dx and dW kernels of ``csrc/fused_ce.cu``, which never
materialize the logits. Otherwise both packages materialize them; a forced
``fused_ce: True`` that cannot run logs the JAX package's warning. The
vocab-parallel composition (tp > 1) arrives with the tensor-parallel slice.
"""

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fce
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger


def vocab_parallel_cross_entropy(logits, targets, label_smoothing=0.0):
    """Per-token cross-entropy: logits [..., vocab], targets [...] int ->
    [...] fp32 losses. A target outside [0, vocab) has target logit 0 (and
    no gradient through it), so its loss is the row's lse, as the JAX
    package's one-hot contraction gives."""
    V = logits.shape[-1]
    logits_f = logits.float()
    m = logits_f.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits_f - m).sum(dim=-1)) + m[..., 0]
    t = targets.long()
    valid = (t >= 0) & (t < V)
    hit = logits_f.gather(-1, t.clamp(0, V - 1)[..., None])[..., 0]
    target_logit = torch.where(valid, hit, 0.0)
    loss = lse - target_logit
    if label_smoothing > 0.0:
        # mean over vocab of -log_softmax == lse - mean(logits)
        smooth = lse - logits_f.mean(dim=-1)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    return loss


def masked_vocab_parallel_cross_entropy(logits, targets, ignore_index=-100,
                                        label_smoothing=0.0):
    """``vocab_parallel_cross_entropy`` with HF-convention ignored labels:
    ``ignore_index`` positions contribute 0 loss and no gradient."""
    valid = targets != ignore_index
    per = vocab_parallel_cross_entropy(
        logits, torch.where(valid, targets, 0), label_smoothing=label_smoothing,
    )
    return torch.where(valid, per, 0.0)


def _is_cuda(x):
    """Whether the fused kernel would run on a CUDA device (one seam, so the
    CPU tests can take the card's branch)."""
    return x.is_cuda


def _want_fused_ce(x, embedding_table, tp=1):
    """Policy half of the CE dispatch, as in the JAX package: True/False from
    ``fused_ce``, or under "auto" whether the [N, V] logits at x's dtype
    (per tp shard) exceed ``fused_ce_auto_threshold_mb``."""
    mode = state.cfg.fused_ce if state.initialized else "auto"
    if mode is True:
        return True
    if mode is False:
        return False
    thresh_mb = state.cfg.fused_ce_auto_threshold_mb if state.initialized else 2048
    logits_mb = x.shape[0] * embedding_table.shape[0] * x.element_size() / 2**20 / tp
    return logits_mb > thresh_mb


def fused_lm_head_cross_entropy(hidden, embedding_table, targets,
                                ignore_index=-100, label_smoothing=0.0,
                                block_n=None, block_v=None):
    """Tied-LM-head cross-entropy ``CE(hidden @ table^T, targets)`` per token.

    Args:
      hidden: [..., D] final hidden states (post final-layernorm).
      embedding_table: [V, D] tied embedding table.
      targets: [...] int ids; ``ignore_index`` entries contribute 0 loss
        and no gradient.
      block_n/block_v: the reference tiling (``ops/fused_ce.auto_blocks``).
    Returns: fp32 per-token losses shaped like ``targets``.
    """
    lead = hidden.shape[:-1]
    D = hidden.shape[-1]
    x = hidden.reshape(-1, D)
    t = targets.reshape(-1)
    valid = t != ignore_index
    t_safe = torch.where(valid, t, 0)
    want = _want_fused_ce(x, embedding_table)
    # fce.fused_ce_ok, with the device test through the _is_cuda seam.
    disabled = fce.fused_ce_disabled()
    can = _is_cuda(x) and not disabled
    if want and can:
        bn, bv = fce.auto_blocks(D, block_n, block_v)
        per = fce.fused_lm_head_ce(x, embedding_table, t_safe, bn, bv, float(label_smoothing))
    else:
        if want and state.initialized and state.cfg.fused_ce is True:
            why = "SMP_DISABLE_FUSED_CE=1 is set" if disabled else "not running on a CUDA device"
            get_logger().warning(
                "fused_ce: True requested but the kernel cannot run here "
                "(%s) — materializing [%d, %d] logits instead.",
                why, x.shape[0], embedding_table.shape[0],
            )
        logits = x @ embedding_table.to(x.dtype).t()
        per = vocab_parallel_cross_entropy(logits, t_safe, label_smoothing=label_smoothing)
    per = torch.where(valid, per, 0.0)
    return per.reshape(lead)


class DistributedCrossEntropy(nn.Module):
    """Module wrapper matching the reference class surface; reduction over
    all tokens ("mean", "sum", or anything else for per-token losses)."""

    def __init__(self, reduction="mean", label_smoothing=0.0):
        super().__init__()
        self.reduction = reduction
        self.label_smoothing = label_smoothing

    def forward(self, logits, targets):
        loss = vocab_parallel_cross_entropy(logits, targets, self.label_smoothing)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss
