"""``DistributedLayerNorm``: layernorm with fp32 moments.

Counterpart of ``smdistributed_modelparallel_tpu/nn/layer_norm.py`` on one
device: the moments and the affine transform are computed in fp32 whatever
the activation dtype, and the result is cast back to it; ``rms=True`` is the
T5-style RMS norm (no mean subtraction). The hidden axis sharded over tp
(``sharded=True``) arrives with the tensor-parallel slice. The parameters
are ``weight`` (the JAX ``scale``) and ``bias``.
"""

import torch
import torch.nn.functional as F
from torch import nn


class DistributedLayerNorm(nn.Module):
    """LayerNorm over the last axis of size ``features``.

    Args:
      features: size of the normalized (hidden) axis.
      epsilon: added to the variance.
      use_scale/use_bias: the affine parameters (ones/zeros at init).
      sharded: the hidden axis is tp-sharded (not ported yet: raises).
      rms: RMS norm; callers pair it with ``use_bias=False``.
      dtype: the parameters' dtype (default fp32).
    """

    def __init__(self, features, epsilon=1e-5, use_scale=True, use_bias=True, sharded=False, rms=False,
                 dtype=None, device=None):
        super().__init__()
        if sharded:
            raise NotImplementedError(
                "DistributedLayerNorm(sharded=True) (the hidden axis sharded "
                "over tp) is not ported to PyTorch yet (the tensor-parallel slice)."
            )
        self.features = features
        self.epsilon = epsilon
        self.rms = rms
        kw = dict(dtype=dtype or torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(features, **kw)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features, **kw)) if use_bias else None

    def reset_parameters(self):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        if not self.rms:
            return F.layer_norm(xf, (xf.shape[-1],), w, b, self.epsilon).to(x.dtype)
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.epsilon)
        if w is not None:
            y = y * w
        if b is not None:
            y = y + b
        return y.to(x.dtype)


# The reference also exposes apex FusedLayerNorm under this module; one class
# covers both surfaces, as in the JAX package.
FusedLayerNorm = DistributedLayerNorm
