"""Bias-GELU and GELU, plain.

Counterpart of ``smdistributed_modelparallel_tpu/nn/gelu.py``: the tanh
approximation the reference's fused bias_gelu uses (HF "gelu_new"). The
fused kernels are ``ops/bias_gelu.py``; these are the unfused functions.
"""

import torch.nn.functional as F


def bias_gelu(x, bias):
    return F.gelu(x + bias, approximate="tanh")


def gelu(x):
    return F.gelu(x, approximate="tanh")
