from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import (
    DistributedCrossEntropy,
    fused_lm_head_cross_entropy,
    vocab_parallel_cross_entropy,
)
from smdistributed_modelparallel_tpu_torch.nn.embedding import DistributedEmbedding
from smdistributed_modelparallel_tpu_torch.nn.gelu import bias_gelu, gelu
from smdistributed_modelparallel_tpu_torch.nn.layer_norm import DistributedLayerNorm, FusedLayerNorm
from smdistributed_modelparallel_tpu_torch.nn.linear import ColumnParallelLinear, DistributedLinear, RowParallelLinear
from smdistributed_modelparallel_tpu_torch.nn.softmax import scaled_causal_masked_softmax, scaled_masked_softmax
from smdistributed_modelparallel_tpu_torch.nn.tp_registry import (
    TensorParallelismRegistry,
    tp_register,
    tp_register_with_module,
)
from smdistributed_modelparallel_tpu_torch.nn.transformer import (
    DistributedAttentionLayer,
    DistributedTransformer,
    DistributedTransformerLayer,
    DistributedTransformerLMHead,
    DistributedTransformerOutputLayer,
)

__all__ = [
    "ColumnParallelLinear",
    "DistributedAttentionLayer",
    "DistributedCrossEntropy",
    "DistributedEmbedding",
    "DistributedLayerNorm",
    "DistributedLinear",
    "DistributedTransformer",
    "DistributedTransformerLMHead",
    "DistributedTransformerLayer",
    "DistributedTransformerOutputLayer",
    "FusedLayerNorm",
    "RowParallelLinear",
    "TensorParallelismRegistry",
    "bias_gelu",
    "fused_lm_head_cross_entropy",
    "gelu",
    "scaled_causal_masked_softmax",
    "scaled_masked_softmax",
    "tp_register",
    "tp_register_with_module",
    "vocab_parallel_cross_entropy",
]
