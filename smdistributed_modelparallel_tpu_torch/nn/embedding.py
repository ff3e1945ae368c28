"""``DistributedEmbedding``: the vocab- or dim-parallel embedding table.

Counterpart of ``smdistributed_modelparallel_tpu/nn/embedding.py``. The JAX
module looks a vocab-split table up by a one-hot product so GSPMD can shard
the contraction; that product has one nonzero term per row, so it equals the
lookup by index that this module does.

Under tensor parallelism (tp > 1) a rank holds its part of the table (the
full table is drawn first, then cut, so every tp degree holds slices of the
same draw):
  - ``split="vocab"``: rows ``[r * ceil(V / tp), ...)`` of tp rank r; where
    tp does not divide V (GPT-2's 50257 at tp 2) the last shard is shorter,
    and each rank's valid range is ``vocab_range``. The lookup masks the ids
    outside the rank's rows and all-reduces over tp (Megatron's
    ``VocabParallelEmbedding``); ``attend`` gives this rank's vocab shard of
    the logits (``gather_logits`` makes them whole). As GSPMD does, the
    result is what the unsharded table gives.
  - ``split="dim"``: columns ``[r * D / tp, (r + 1) * D / tp)`` (tp must
    divide D); the lookup gathers the hidden axis; ``attend`` contracts the
    rank's columns and all-reduces.
"""

import torch
import torch.nn.functional as F
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.collectives import (
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    scatter_to_tp,
)
from smdistributed_modelparallel_tpu_torch.nn.utils import (
    TPSpec,
    divisible_by_tp,
    normal_weight_,
    shard_parameters_,
    tp_enabled,
    tp_group,
    tp_rank,
    tp_size,
)
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


class DistributedEmbedding(nn.Module):
    """Embedding table ``weight`` [num_embeddings, features] (the JAX
    ``embedding``), normal(0, ``init_scale``) at init; under tp this rank's
    part of it."""

    def __init__(self, num_embeddings, features, split="vocab", dtype=None, init_scale=0.02,
                 one_hot_lookup=None, device=None):
        super().__init__()
        if split not in ("vocab", "dim"):
            raise SMPValidationError(f"DistributedEmbedding split must be 'vocab' or 'dim', got {split!r}")
        self.num_embeddings = num_embeddings
        self.features = features
        self.split = split
        self.init_scale = init_scale
        self.one_hot_lookup = one_hot_lookup  # kept for the JAX signature: the lookup is equal
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, dtype=dtype or torch.float32,
                                               device=device))
        self.reset_parameters()
        if split == "dim":
            divisible_by_tp(features, "DistributedEmbedding(split='dim') features")
            spec = TPSpec(1, features)
        else:
            spec = TPSpec(0, num_embeddings)
        shard_parameters_(self, {"weight": spec})
        self._sizes = [hi - lo for lo, hi in spec.parts(tp_size())] if tp_enabled() else None

    def reset_parameters(self, generator=None):
        normal_weight_(self, self.init_scale, generator)

    @property
    def vocab_sharded(self):
        """Whether this rank holds a vocab shard (tp > 1, ``split="vocab"``)."""
        return self.split == "vocab" and self._sizes is not None

    @property
    def vocab_range(self):
        """This rank's rows ``(lo, hi)`` of the vocabulary."""
        if not self.vocab_sharded:
            return 0, self.num_embeddings
        lo = sum(self._sizes[:tp_rank()])
        return lo, lo + self._sizes[tp_rank()]

    def forward(self, ids):
        if self._sizes is None:
            return F.embedding(ids, self.weight)
        group = tp_group()
        if self.split == "dim":
            return gather_from_tp(F.embedding(ids, self.weight), group, -1, split_grad=True)
        lo, hi = self.vocab_range
        inside = (ids >= lo) & (ids < hi)
        out = F.embedding(torch.where(inside, ids - lo, 0), self.weight)
        return reduce_from_tp(out * inside[..., None].to(out.dtype), group)

    def attend(self, x):
        """Tied-weights logits ``x @ table^T`` in x's dtype: under tp with
        ``split="vocab"`` this rank's vocab shard of them [..., hi - lo]."""
        if self._sizes is None:
            return F.linear(x, self.weight.to(x.dtype))
        group = tp_group()
        if self.split == "dim":
            return reduce_from_tp(F.linear(scatter_to_tp(x, group, -1), self.weight.to(x.dtype)), group)
        return F.linear(copy_to_tp(x, group), self.weight.to(x.dtype))

    def gather_logits(self, logits):
        """``attend``'s logits whole on every tp rank (gathered along the
        vocab under ``split="vocab"``, the uneven shard included)."""
        if not self.vocab_sharded:
            return logits
        return gather_from_tp(logits, tp_group(), -1, split_grad=True, sizes=self._sizes)
