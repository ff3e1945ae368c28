from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_1p5b, gpt2_124m
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

__all__ = ["TransformerLM", "gpt2", "gpt2_124m", "gpt2_1p5b"]
