"""``DistributedEmbedding``: the vocab- or dim-parallel embedding table.

Counterpart of ``smdistributed_modelparallel_tpu/nn/embedding.py`` at
tp = 1, where the table is whole on the one device. The JAX module looks a
vocab-split table up by a one-hot product so GSPMD can shard the
contraction; at tp = 1 that product has one nonzero term per row, so it
equals the lookup by index that this module does. ``attend`` gives the tied
head's logits ``x @ table^T``. Sharding the table over tp arrives with the
tensor-parallel slice.
"""

import torch
import torch.nn.functional as F
from torch import nn

from smdistributed_modelparallel_tpu_torch.nn.utils import tp_enabled
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


class DistributedEmbedding(nn.Module):
    """Embedding table ``weight`` [num_embeddings, features] (the JAX
    ``embedding``), normal(0, ``init_scale``) at init."""

    def __init__(self, num_embeddings, features, split="vocab", dtype=None, init_scale=0.02,
                 one_hot_lookup=None, device=None):
        super().__init__()
        if split not in ("vocab", "dim"):
            raise SMPValidationError(f"DistributedEmbedding split must be 'vocab' or 'dim', got {split!r}")
        self.num_embeddings = num_embeddings
        self.features = features
        self.split = split
        self.init_scale = init_scale
        self.one_hot_lookup = one_hot_lookup  # kept for the JAX signature: equal at tp = 1
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, dtype=dtype or torch.float32,
                                               device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.init_scale, generator=generator)

    def _check_tp(self):
        if tp_enabled():
            raise NotImplementedError(
                "DistributedEmbedding under tensor parallelism (a tp-sharded "
                "table) is not ported to PyTorch yet (the tensor-parallel slice)."
            )

    def forward(self, ids):
        self._check_tp()
        return F.embedding(ids, self.weight)

    def attend(self, x):
        """Tied-weights logits ``x @ table^T`` in x's dtype."""
        self._check_tp()
        return F.linear(x, self.weight.to(x.dtype))
