from smdistributed_modelparallel_tpu_torch.models.encoder_decoder import EncoderDecoderLM, t5_style, t5_style_3b
from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_1p5b, gpt2_124m
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

__all__ = ["EncoderDecoderLM", "TransformerLM", "gpt2", "gpt2_124m", "gpt2_1p5b", "t5_style", "t5_style_3b"]
