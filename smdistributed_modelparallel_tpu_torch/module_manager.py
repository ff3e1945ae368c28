"""Checkpoint key paths of the PyTorch port.

Counterpart of the ``path_key`` of ``smdistributed_modelparallel_tpu/
module_manager.py``: the single stringifier of checkpoint keys. The JAX
package names every leaf of a parameter or optimizer tree by the '/'-joined
path that ``jax.tree_util.tree_flatten_with_path`` gives it: dict keys, tuple
indices (the ``0/`` of an optax chain) and namedtuple fields (``mu``, ``nu``,
``count``). ``tree_flatten_with_path`` here walks the same containers in the
same order (dict keys sorted, tuples and namedtuples in field order, ``None``
and empty namedtuples holding no leaf), so the port writes and reads the same
keys. The rest of the JAX module (annotations, sharding resolution) arrives
with the tensor-parallel slice.
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
