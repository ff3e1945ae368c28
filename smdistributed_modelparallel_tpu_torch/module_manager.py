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

``ModuleManager`` holds the JAX module manager's activation-checkpoint
registry (``set_activation_checkpointing``, ``checkpoint_config``,
``checkpoint_configs``), keyed by '/'-joined module path prefixes (the torch
attribute names; ``"main"``, ``""`` and ``"/"`` mean the whole model);
``smp.set_activation_checkpointing`` fills it and ``DistributedModel`` reads
it. The rest of the JAX module (partition assignments, tp marks, sharding
resolution) arrives with the tensor- and pipeline-parallel slices.
"""


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
    """The activation-checkpoint registry: module path prefix -> config."""

    def __init__(self):
        self._ckpt_configs = {}

    def set_activation_checkpointing(self, prefix, **config):
        self._ckpt_configs[_normalize_prefix(prefix)] = config

    def checkpoint_config(self, prefix):
        return self._ckpt_configs.get(_normalize_prefix(prefix))

    @property
    def checkpoint_configs(self):
        return dict(self._ckpt_configs)
