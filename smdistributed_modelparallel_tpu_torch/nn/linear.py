"""``DistributedLinear`` and its building-block names.

Counterpart of ``smdistributed_modelparallel_tpu/nn/linear.py``:
``DistributedLinear`` (row-parallel: the weight's input dimension carries
the tp axis), ``ColumnParallelLinear`` (output-partitioned) and
``RowParallelLinear`` (``DistributedLinear`` under its Megatron name). On
one device the three compute the same ``y = x W^T + b``. At tp > 1 (the
full weight drawn, then cut; tp must divide the partitioned features):
  - ``ColumnParallelLinear`` holds rows ``[r * out / tp, ...)`` of the
    weight and of the bias; it takes the whole input (the copy-to-tp region:
    backward all-reduce) and gives this rank's [..., out / tp] block, which
    a ``RowParallelLinear`` consumes as it is (the Megatron pair; the JAX
    layer gives the same values as one tp-sharded array);
  - ``DistributedLinear`` / ``RowParallelLinear`` holds columns ``[r * in /
    tp, ...)`` of the weight and the whole bias; it takes this rank's
    [..., in / tp] block, or the whole input (it keeps its block; backward
    all-gathers), all-reduces the partial products over tp and adds the bias
    once.
The ``tp_overlap: "ring"`` decomposition is ROADMAP item 7b: at tp > 1 it
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

from smdistributed_modelparallel_tpu_torch.backend.collectives import copy_to_tp, reduce_from_tp, scatter_to_tp
from smdistributed_modelparallel_tpu_torch.nn.transformer import _linear, _normal_
from smdistributed_modelparallel_tpu_torch.nn.utils import (
    TPSpec,
    divisible_by_tp,
    shard_parameters_,
    tp_group,
    tp_ring_active,
)


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
        self._shard()

    def _shard(self):
        divisible_by_tp(self.in_features, f"{type(self).__name__} in_features")
        shard_parameters_(self, {"weight": TPSpec(1, self.in_features)})

    def reset_parameters(self, generator=None):
        _normal_([self], self.init_scale, generator)

    def forward(self, x):
        tp_ring_active()
        group = tp_group()
        if group is None:
            return _linear(x, self.weight, self.bias, self._site)
        if x.shape[-1] == self.in_features:
            x = scatter_to_tp(x, group, -1)
        y = reduce_from_tp(_linear(x, self.weight, site=self._site), group)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


class ColumnParallelLinear(DistributedLinear):
    """Output-partitioned linear (the head-partitioned QKV's layout); at
    tp = 1 the same product through the ``linear_col`` fp8 seam."""

    _site = "linear_col"

    def _shard(self):
        divisible_by_tp(self.out_features, f"{type(self).__name__} out_features")
        spec = TPSpec(0, self.out_features)
        shard_parameters_(self, {"weight": spec, "bias": spec})

    def forward(self, x):
        tp_ring_active()
        return _linear(copy_to_tp(x, tp_group()), self.weight, self.bias, self._site)


class RowParallelLinear(DistributedLinear):
    """Input-partitioned linear consuming a tp-sharded feature axis (the
    Megatron pair of ``ColumnParallelLinear``): ``DistributedLinear`` under
    its building-block name."""
