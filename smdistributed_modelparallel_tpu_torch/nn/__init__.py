from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import (
    DistributedCrossEntropy,
    fused_lm_head_cross_entropy,
    vocab_parallel_cross_entropy,
)
from smdistributed_modelparallel_tpu_torch.nn.embedding import DistributedEmbedding
from smdistributed_modelparallel_tpu_torch.nn.gelu import bias_gelu, gelu
from smdistributed_modelparallel_tpu_torch.nn.layer_norm import DistributedLayerNorm, FusedLayerNorm
from smdistributed_modelparallel_tpu_torch.nn.transformer import (
    DistributedAttentionLayer,
    DistributedTransformer,
    DistributedTransformerLayer,
    DistributedTransformerLMHead,
    DistributedTransformerOutputLayer,
)

__all__ = [
    "DistributedAttentionLayer",
    "DistributedCrossEntropy",
    "DistributedEmbedding",
    "DistributedLayerNorm",
    "DistributedTransformer",
    "DistributedTransformerLMHead",
    "DistributedTransformerLayer",
    "DistributedTransformerOutputLayer",
    "FusedLayerNorm",
    "bias_gelu",
    "fused_lm_head_cross_entropy",
    "gelu",
    "vocab_parallel_cross_entropy",
]
