"""Checkpoint key paths and the activation-checkpoint registry of the
PyTorch port.

Counterpart of the ``path_key`` of ``smdistributed_modelparallel_tpu/
module_manager.py``: the single stringifier of checkpoint keys. The JAX
package names every leaf of a parameter or optimizer tree by the '/'-joined
path that ``jax.tree_util.tree_flatten_with_path`` gives it: dict keys, tuple
indices (the ``0/`` of an optax chain) and namedtuple fields (``mu``, ``nu``,
``count``). ``tree_flatten_with_path`` here walks the same containers in the
same order (dict keys sorted, tuples and namedtuples in field order, ``None``
and empty namedtuples holding no leaf), so the port writes and reads the same
keys.

``ModuleManager`` holds the JAX module manager's annotations, keyed by
'/'-joined module path prefixes (the torch attribute names; ``"main"``,
``""`` and ``"/"`` mean the whole model):

- the activation-checkpoint registry (``set_activation_checkpointing``,
  ``checkpoint_config``, ``checkpoint_configs``);
- the tensor-parallel marks (``set_tensor_parallelism``, ``tp_marked``,
  ``tp_config``, ``tp_marks``) and the ``smp.tensor_parallelism()`` context
  (``_active_tp``), which ``nn/auto_distribute.distribute_tree`` reads when
  ``DistributedModel`` is built;
- the pipeline stages (the ``partition(stage)`` context, ``set_partition``,
  ``get_manual_partitions``, ``stage_of``): the manual pins
  (``"<layer_path>#<i>"``) feed the partitioner when a ``DistributedModel``
  is built at pp > 1 (``parallel/partition.py``), which installs its
  assignment (``set_partition_assignment``); ``stage_of`` reads it by the
  longest matching prefix, as in the JAX package.

``smp.set_activation_checkpointing``, ``smp.set_tensor_parallelism`` and
``smp.set_partition`` fill it after ``smp.init``; ``smp.init`` and
``smp.reset`` clear it. The JAX module's sharding resolution arrives with the
tensor- and pipeline-parallel slices.
"""

from contextlib import contextmanager

from smdistributed_modelparallel_tpu_torch.utils.exceptions import PartitionError


def path_key(path):
    """Canonical '/'-joined string for a key path: entries with ``key``,
    ``idx`` or ``name`` (the JAX package's key objects) give that field,
    plain strings and ints give themselves."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def tree_flatten_with_path(tree, path=()):
    """``[(path, leaf), ...]`` of a tree of dicts, tuples, lists and
    namedtuples, in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for f in tree._fields for item in tree_flatten_with_path(getattr(tree, f), path + (f,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def _normalize_prefix(prefix):
    if prefix in ("main", "", "/"):
        return ""
    return prefix.strip("/")


class ModuleManager:
    """Module path prefix -> activation-checkpoint config, tp mark and
    pipeline stage."""

    def __init__(self):
        self._ckpt_configs = {}
        self._tp_marks = {}               # path prefix -> tp_config dict
        self._manual_partitions = {}      # path prefix -> stage
        self._active_tp = None            # the smp.tensor_parallelism() context's config
        self._active_partition = None     # the smp.partition() context's stage
        self._partition_assignment = None  # the partitioner's {prefix: stage}

    # -- activation checkpointing -----------------------------------------

    def set_activation_checkpointing(self, prefix, **config):
        self._ckpt_configs[_normalize_prefix(prefix)] = config

    def checkpoint_config(self, prefix):
        return self._ckpt_configs.get(_normalize_prefix(prefix))

    @property
    def checkpoint_configs(self):
        return dict(self._ckpt_configs)

    # -- pipeline stages ----------------------------------------------------

    @contextmanager
    def partition(self, stage):
        """Registered modules built inside are assigned to pipeline stage
        ``stage`` (stamped at construction, recorded when the
        ``DistributedModel`` is built)."""
        prev, self._active_partition = self._active_partition, stage
        try:
            yield
        finally:
            self._active_partition = prev

    def set_partition(self, prefix, stage):
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        pp = state.cfg.pipeline_parallel_degree if state.cfg is not None else 1
        if not 0 <= stage < pp:
            raise PartitionError(f"Partition {stage} out of range [0, {pp}).")
        self._manual_partitions[_normalize_prefix(prefix)] = stage

    def get_manual_partitions(self):
        return dict(self._manual_partitions)

    def set_partition_assignment(self, assignment):
        self._partition_assignment = {_normalize_prefix(k): v for k, v in assignment.items()}

    def stage_of(self, path):
        """The pipeline stage that runs ``path``: the assignment's entry of
        the longest prefix that matches it (0 before any partition)."""
        if self._partition_assignment is None:
            return 0
        best, best_len = 0, -1
        for prefix, stage in self._partition_assignment.items():
            if (prefix == "" or path == prefix or path.startswith(prefix + "/")) and len(prefix) > best_len:
                best, best_len = stage, len(prefix)
        return best

    # -- tensor parallelism -------------------------------------------------

    def set_tensor_parallelism(self, prefix, enabled=True, **tp_config):
        if enabled:
            self._tp_marks[_normalize_prefix(prefix)] = tp_config
        else:
            self._tp_marks.pop(_normalize_prefix(prefix), None)

    def tp_marked(self, prefix):
        return _normalize_prefix(prefix) in self._tp_marks

    def tp_config(self, prefix):
        return self._tp_marks.get(_normalize_prefix(prefix), {})

    @property
    def tp_marks(self):
        return dict(self._tp_marks)
