"""GPT-2 model family.

A copy of the zoo in ``smdistributed_modelparallel_tpu/models/gpt2.py``
(published GPT-2 sizes as ``TransformerLM`` configs), plus
``init_gpt2_weights_``: GPT-2's own initialisation (normal(0, 0.02) weights
and embeddings, zero biases, unit LayerNorm) drawn from a
``torch.Generator``, for runs that need random weights of the right scale.
"""

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

_CONFIGS = {
    "gpt2_124m": dict(d_model=768, n_layers=12, n_heads=12),
    "gpt2_350m": dict(d_model=1024, n_layers=24, n_heads=16),
    "gpt2_774m": dict(d_model=1280, n_layers=36, n_heads=20),
    "gpt2_1p5b": dict(d_model=1600, n_layers=48, n_heads=25),
}


def gpt2(size="gpt2_124m", vocab_size=50257, max_len=1024, **overrides):
    cfg = dict(_CONFIGS[size])
    cfg.update(
        vocab_size=vocab_size,
        max_len=max_len,
        pos_type="learned",
        tie_weights=True,
    )
    cfg.update(overrides)
    return TransformerLM(**cfg)


def gpt2_124m(**overrides):
    return gpt2("gpt2_124m", **overrides)


def gpt2_1p5b(**overrides):
    return gpt2("gpt2_1p5b", **overrides)


@torch.no_grad()
def init_gpt2_weights_(module, generator, std=0.02):
    """Re-initialise ``module`` in place as GPT-2 does, from ``generator``
    (a ``torch.Generator`` on the module's device)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
