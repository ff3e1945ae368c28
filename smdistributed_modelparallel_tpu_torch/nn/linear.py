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
Under ``tp_overlap: "ring"`` at tp > 1 (an input of at least two dimensions
whose second-to-last, the sequence, tp divides) the products are
``ops/collective_matmul.py``'s rings: ``ColumnParallelLinear`` enters the
all-gather ring with the rank's T block of its input, ``DistributedLinear``
the reduce-scatter ring, whose T-sharded sum is gathered back. The JAX layer
leaves the row-parallel ring's output sequence-sharded ("the logical value
is identical; only the layout differs"); a port module holds its value as a
tensor, so each layer returns what it returns without the ring (the whole
output, or the rank's block): the ring changes how the value is computed,
not what the module gives.

The modules keep ``torch.nn.Linear``'s parameter names and layout (``weight``
[out, in], ``bias`` [out]), so a ``nn.Linear`` that ``smp.tensor_parallelism``
swaps for one of them (``nn/auto_distribute.py``) hands over its tensors and
the model's ``state_dict`` keys do not change; the JAX ``kernel`` is the
transposed weight. The product runs in x's dtype and the bias is added after
it is rounded, as the flax layer does. Under ``matmul_precision: fp8``
(inside an ``@smp.step``, where ``quant.fp8_trace_active()``) the product
goes through ``quant.fp8_matmul`` at the JAX package's seams: slots
``linear_row`` (``DistributedLinear``, ``RowParallelLinear``) and
``linear_col`` (``ColumnParallelLinear``), also at tp > 1 (the amax then the
tp group's, ``quant.finalize``); under the ring the operands round at the
ring's boundary instead (slots ``ring_rs.*``, ``ring_ag.*``).
"""

import torch
from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.collectives import copy_to_tp, reduce_from_tp, scatter_to_tp
from smdistributed_modelparallel_tpu_torch.nn.transformer import _linear, _normal_
from smdistributed_modelparallel_tpu_torch.ops import collective_matmul as cm
from smdistributed_modelparallel_tpu_torch.nn.utils import (
    TPSpec,
    divisible_by_tp,
    shard_parameters_,
    tp_group,
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
        group = tp_group()
        if group is None:
            return _linear(x, self.weight, self.bias, self._site)
        if x.shape[-1] == self.in_features:
            x = scatter_to_tp(x, group, -1)
        if cm.ring_applies("rs", x):
            y = cm.ring_rs_matmul(x, self.weight.to(x.dtype))
        else:
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
        group = tp_group()
        if cm.ring_applies("ag", x):
            return cm.ring_ag_matmul(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))
        return _linear(copy_to_tp(x, group), self.weight, self.bias, self._site, col=True)


class RowParallelLinear(DistributedLinear):
    """Input-partitioned linear consuming a tp-sharded feature axis (the
    Megatron pair of ``ColumnParallelLinear``): ``DistributedLinear`` under
    its building-block name."""
