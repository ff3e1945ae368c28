"""``DistributedLinear`` and its building-block names, at tp = 1.

Counterpart of ``smdistributed_modelparallel_tpu/nn/linear.py``:
``DistributedLinear`` (row-parallel: the weight's input dimension would
carry the tp axis), ``ColumnParallelLinear`` (output-partitioned) and
``RowParallelLinear`` (``DistributedLinear`` under its Megatron name). On
one device the three compute the same ``y = x W^T + b``; the partitions,
their collectives and the ``tp_overlap: "ring"`` decomposition arrive with
the tensor-parallel slice, and until then tensor_parallel_degree > 1
raises.

The modules keep ``torch.nn.Linear``'s parameter names and layout (``weight``
[out, in], ``bias`` [out]), so a ``nn.Linear`` that ``smp.tensor_parallelism``
swaps for one of them (``nn/auto_distribute.py``) hands over its tensors and
the model's ``state_dict`` keys do not change; the JAX ``kernel`` is the
transposed weight. The product runs in x's dtype and the bias is added after
it is rounded, as the flax layer does. Under ``matmul_precision: fp8``
(inside an ``@smp.step``, where ``quant.fp8_trace_active()``) the product
goes through ``quant.fp8_matmul`` at the JAX package's seams: slots
``linear_row`` (``DistributedLinear``, ``RowParallelLinear``) and
``linear_col`` (``ColumnParallelLinear``).
"""

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.nn.transformer import _linear, _not_ported
from smdistributed_modelparallel_tpu_torch.nn.utils import tp_size


def _check_tp(layer):
    if tp_size() > 1:
        raise _not_ported(f"{layer} at tensor_parallel_degree > 1 (its partitions and tp_overlap: 'ring')",
                          "the tensor-parallel slice")


class DistributedLinear(nn.Module):
    """Row-parallel linear ``y = x W^T + b``: ``weight`` [out_features,
    in_features] normal(0, ``init_scale``), ``bias`` zeros (none with
    ``bias=False``)."""

    _site = "linear_row"  # the fp8 seam's slot prefix

    def __init__(self, in_features, out_features, bias=True, dtype=None, device=None, init_scale=0.02):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.init_scale = init_scale
        kw = dict(dtype=dtype or torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw))
        self.bias = nn.Parameter(torch.empty(out_features, **kw)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.init_scale, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        _check_tp(type(self).__name__)
        return _linear(x, self.weight, self.bias, self._site)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


class ColumnParallelLinear(DistributedLinear):
    """Output-partitioned linear (the head-partitioned QKV's layout); at
    tp = 1 the same product through the ``linear_col`` fp8 seam."""

    _site = "linear_col"


class RowParallelLinear(DistributedLinear):
    """Input-partitioned linear consuming a tp-sharded feature axis (the
    Megatron pair of ``ColumnParallelLinear``): ``DistributedLinear`` under
    its building-block name."""
