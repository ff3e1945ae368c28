"""Microbatch splitting of step arguments and per-microbatch outputs.

Counterpart of ``smdistributed_modelparallel_tpu/backend/split.py``
(``TensorSplitter``, ``StepOutput``) over torch tensors, with the same
semantics: nested structures (dicts, lists, tuples) are traversed, named
arguments can be exempted (``non_split_inputs``) or split along a custom
axis (``input_split_axes``), and any object may implement the ``smp_slice``
protocol (``smp_slice(num_mb, mb, axis) -> piece``). A splittable tensor
becomes a ``DeferredSplit`` whose ``stack()`` is the
``[num_mb, B // num_mb, ...]`` view and ``slice(mb)`` one microbatch.
``StepOutput`` holds the per-microbatch outputs stacked along a leading
``[num_mb]`` axis.
"""

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.utils.exceptions import MicrobatchError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray))


def tree_map(fn, tree, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts, lists and tuples."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(mapped) if not hasattr(tree, "_fields") else type(tree)(*mapped)
    return fn(tree)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


class TensorSplitter:
    def __init__(self, num_microbatches, non_split_inputs=None, input_split_axes=None):
        self.num_microbatches = num_microbatches
        self.non_split_inputs = set(non_split_inputs or [])
        self.input_split_axes = dict(input_split_axes or {})

    def stack_microbatches(self, args, kwargs, arg_names=None):
        """Return (args, kwargs) with every splittable tensor wrapped as a
        ``DeferredSplit`` along its split axis and everything else as
        ``NonSplit``.

        ``arg_names`` gives the positional-parameter names of the user step
        function so ``non_split_inputs`` / ``input_split_axes`` can refer to
        positional args by name, as in the reference.
        """
        arg_names = arg_names or []
        new_args = []
        for i, a in enumerate(args):
            name = arg_names[i] if i < len(arg_names) else None
            new_args.append(self._split_value(a, name))
        new_kwargs = {k: self._split_value(v, k) for k, v in kwargs.items()}
        return tuple(new_args), new_kwargs

    def _split_value(self, value, name):
        if name is not None and name in self.non_split_inputs:
            return NonSplit(value)
        axis = self.input_split_axes.get(name, 0)
        return tree_map(
            lambda leaf: self._split_leaf(leaf, axis, name),
            value,
            is_leaf=lambda x: hasattr(x, "smp_slice"),
        )

    def _split_leaf(self, leaf, axis, name):
        if hasattr(leaf, "smp_slice"):
            pieces = [
                torch.as_tensor(leaf.smp_slice(self.num_microbatches, mb, axis))
                for mb in range(self.num_microbatches)
            ]
            return DeferredSplit(torch.stack(pieces, dim=0), 0, self.num_microbatches, stacked=True)
        if not _is_array(leaf):
            if self.num_microbatches > 1 and leaf is not None and not isinstance(
                leaf, (bool, int, float, str, bytes)
            ):
                logger.debug("Argument %s of type %s is not splittable; broadcasting.",
                             name, type(leaf).__name__)
            return NonSplit(leaf)
        if leaf.ndim <= axis:
            return NonSplit(leaf)
        dim = leaf.shape[axis]
        if dim % self.num_microbatches != 0:
            raise MicrobatchError(
                f"Axis {axis} of argument '{name}' has size {dim}, not divisible by "
                f"microbatches={self.num_microbatches}."
            )
        return DeferredSplit(leaf, axis, self.num_microbatches, stacked=False)


class NonSplit:
    """Marks a value broadcast to all microbatches."""

    def __init__(self, value):
        self.value = value


def stack_leaf(leaf, axis, num_mb, stacked=False):
    """[B, ...] -> [num_mb, B/num_mb, ...] restack along ``axis`` (a view
    where the layout allows)."""
    if stacked:
        return leaf
    leaf = torch.as_tensor(leaf)
    mb_dim = leaf.shape[axis] // num_mb
    new_shape = leaf.shape[:axis] + (num_mb, mb_dim) + leaf.shape[axis + 1:]
    return torch.movedim(leaf.reshape(new_shape), axis, 0)


class DeferredSplit:
    """A splittable leaf: ``stack()`` gives the [num_mb, ...] view,
    ``slice(mb)`` one microbatch."""

    __slots__ = ("value", "axis", "num_mb", "stacked")

    def __init__(self, value, axis, num_mb, stacked=False):
        self.value = value
        self.axis = axis
        self.num_mb = num_mb
        self.stacked = stacked

    def stack(self, value=None):
        leaf = self.value if value is None else value
        return stack_leaf(leaf, self.axis, self.num_mb, self.stacked)

    def slice(self, mb):
        leaf = torch.as_tensor(self.value)
        if self.stacked:
            return leaf[mb]
        mb_dim = leaf.shape[self.axis] // self.num_mb
        return torch.narrow(leaf, self.axis, mb * mb_dim, mb_dim)


def microbatch_slice(stacked_tree, mb):
    """Select microbatch ``mb`` from a tree of NonSplit/DeferredSplit/stacked
    leaves."""

    def pick(x):
        if isinstance(x, NonSplit):
            return x.value
        if isinstance(x, DeferredSplit):
            return x.slice(mb)
        return x[mb]

    return tree_map(pick, stacked_tree, is_leaf=lambda x: isinstance(x, (NonSplit, DeferredSplit)))


class StepOutput:
    """Per-microbatch outputs of an ``@smp.step`` function, stacked along a
    leading [num_mb] axis, with the reference's reduction API."""

    def __init__(self, stacked):
        self._stacked = stacked

    @property
    def outputs(self):
        """List of per-microbatch values (reference-compat accessor)."""
        n = tree_leaves(self._stacked)[0].shape[0]
        return [tree_map(lambda x: x[i], self._stacked) for i in range(n)]

    def reduce_mean(self):
        return tree_map(lambda x: x.mean(dim=0), self._stacked)

    def reduce_sum(self):
        return tree_map(lambda x: x.sum(dim=0), self._stacked)

    def concat(self):
        return tree_map(
            lambda x: x.reshape((-1,) + tuple(x.shape[2:])) if x.ndim >= 2 else x.reshape(-1),
            self._stacked,
        )

    def stack(self):
        return self._stacked

    def __repr__(self):
        shapes = tree_map(lambda x: tuple(x.shape), self._stacked)
        return f"StepOutput(num_microbatches-stacked, shapes={shapes})"
