from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import (
    DistributedCrossEntropy,
    fused_lm_head_cross_entropy,
    vocab_parallel_cross_entropy,
)

__all__ = [
    "DistributedCrossEntropy",
    "fused_lm_head_cross_entropy",
    "vocab_parallel_cross_entropy",
]
