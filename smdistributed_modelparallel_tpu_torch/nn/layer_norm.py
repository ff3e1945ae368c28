"""``DistributedLayerNorm``: layernorm with fp32 moments.

Counterpart of ``smdistributed_modelparallel_tpu/nn/layer_norm.py`` on one
device: the moments and the affine transform are computed in fp32 whatever
the activation dtype, and the result is cast back to it; ``rms=True`` is the
T5-style RMS norm (no mean subtraction). The parameters are ``weight`` (the
JAX ``scale``) and ``bias``.

``sharded=True`` at tp > 1: the input is this rank's [..., features / tp]
block of the hidden axis and so are the affine parameters (tp must divide
``features``). The moments are taken over the full axis, as all-reduced sums
of the local parts (the reference's two-phase kernel pair; GSPMD's
decomposition in the JAX package); their backward all-reduces too, since
every rank's block depends on them.
"""

import torch
import torch.nn.functional as F
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.collectives import reduce_from_tp
from smdistributed_modelparallel_tpu_torch.nn.utils import TPSpec, divisible_by_tp, shard_parameters_, tp_group


class DistributedLayerNorm(nn.Module):
    """LayerNorm over the last axis of size ``features``.

    Args:
      features: size of the normalized (hidden) axis.
      epsilon: added to the variance.
      use_scale/use_bias: the affine parameters (ones/zeros at init).
      sharded: the hidden axis (input and parameters) is tp-sharded.
      rms: RMS norm; callers pair it with ``use_bias=False``.
      dtype: the parameters' dtype (default fp32).
    """

    def __init__(self, features, epsilon=1e-5, use_scale=True, use_bias=True, sharded=False, rms=False,
                 dtype=None, device=None):
        super().__init__()
        self.features = features
        self.epsilon = epsilon
        self.rms = rms
        kw = dict(dtype=dtype or torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(features, **kw)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features, **kw)) if use_bias else None
        self.sharded = sharded and tp_group() is not None
        if self.sharded:
            divisible_by_tp(features, "DistributedLayerNorm(sharded=True) features")
            shard_parameters_(self, {"weight": TPSpec(0, features), "bias": TPSpec(0, features)})

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
        if self.sharded:
            return self._sharded(xf, w, b).to(x.dtype)
        if not self.rms:
            return F.layer_norm(xf, (xf.shape[-1],), w, b, self.epsilon).to(x.dtype)
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.epsilon)
        if w is not None:
            y = y * w
        if b is not None:
            y = y + b
        return y.to(x.dtype)

    def _sharded(self, xf, w, b):
        """The moments over the full hidden axis from this rank's block."""
        group = tp_group()

        def mean(t):
            return reduce_from_tp(t.sum(dim=-1, keepdim=True), group, sum_grad=True) / self.features

        if self.rms:
            y = xf * torch.rsqrt(mean(xf.square()) + self.epsilon)
        else:
            centered = xf - mean(xf)
            y = centered * torch.rsqrt(mean(centered.square()) + self.epsilon)
        if w is not None:
            y = y * w
        if b is not None:
            y = y + b
        return y


# The reference also exposes apex FusedLayerNorm under this module; one class
# covers both surfaces, as in the JAX package.
FusedLayerNorm = DistributedLayerNorm
