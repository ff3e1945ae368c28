"""Automatic distribution: swap tp-marked modules for their ``smp.nn``
counterparts.

Counterpart of ``smdistributed_modelparallel_tpu/nn/auto_distribute.py``.
Modules marked for tensor parallelism, by the ``smp.tensor_parallelism()``
context around their construction or by ``smp.set_tensor_parallelism(path)``,
are rebuilt as their registered distributed classes when the
``DistributedModel`` is built, before it moves to its device.

- Marks at construction: registering a class (``tp_registry.register``)
  wraps its ``__init__`` (``record_construction``), the reference's
  ``patch_constructor`` design. Each instance keeps its constructor
  arguments; inside ``smp.tensor_parallelism()`` it is stamped with the
  context's tp config, inside ``smp.partition(stage)`` with the stage.
- ``distribute_tree`` walks ``named_children`` (paths are the '/'-joined
  attribute names, the module manager's keys) and replaces each marked child
  of a registered class by ``registry.distribute(...)`` on its recorded
  arguments. The replacement takes the original's tensors when their names
  and shapes agree (``nn.Linear`` -> ``DistributedLinear``, ``nn.Embedding``
  -> ``DistributedEmbedding``); otherwise it keeps its own init, with a
  warning. It does not descend into ``smp.nn`` modules, which build their own
  internals (as the JAX walk never sees a flax module's ``setup`` children).
  Partition stamps go to the module manager; activation-checkpoint configs
  turn on the ``activation_checkpointing`` flag of every module they touch.
- ``attach_hooks``: a registration's forward and return hooks, as torch
  forward hooks on the distributed module itself, so its parameter names do
  not change (the JAX package's scope-sharing ``HookedModule``).
"""

import functools

from torch import nn

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import TensorParallelismError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

_CTOR = "_smp_ctor"
_TP_MARK = "_smp_tp_mark"
_PARTITION_MARK = "_smp_partition"
_NN_PACKAGE = "smdistributed_modelparallel_tpu_torch.nn."


def record_construction(cls):
    """Wrap ``cls.__init__`` (once) to keep each instance's constructor
    arguments and stamp the active tp and partition marks on it. Only
    instances of ``cls`` itself are recorded: a registered subclass records
    its own arguments."""
    if getattr(cls.__init__, "_smp_records", None) is cls:
        return
    init = cls.__init__

    @functools.wraps(init)
    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if type(self) is not cls:
            return
        self.__dict__[_CTOR] = (args, kwargs)
        mm = state.module_manager
        if mm is None:
            return
        tp = mm._active_tp
        if tp is not None and tp.get("enabled", True):
            self.__dict__[_TP_MARK] = {k: v for k, v in tp.items() if k != "enabled"}
        if mm._active_partition is not None:
            self.__dict__[_PARTITION_MARK] = mm._active_partition

    __init__._smp_records = cls
    cls.__init__ = __init__


def attach_hooks(module, fwd_hook=None, ret_hook=None):
    """Run ``fwd_hook(*args, **kwargs) -> (args, kwargs)`` before
    ``module``'s forward and ``ret_hook(out) -> out`` after it."""
    if fwd_hook is not None:
        module.register_forward_pre_hook(lambda m, args, kwargs: fwd_hook(*args, **kwargs), with_kwargs=True)
    if ret_hook is not None:
        module.register_forward_hook(lambda m, args, out: ret_hook(out))
    return module


def _tp_config(module, path, mm):
    """The tp config ``module`` at ``path`` is marked with, or None."""
    mark = module.__dict__.get(_TP_MARK)
    if mark is None and mm is not None and mm.tp_marked(path):
        mark = mm.tp_config(path)
    return None if mark is None else dict(mark)


def _carry_values(orig, dist, path):
    src, dst = orig.state_dict(), dist.state_dict()
    if src.keys() == dst.keys() and all(src[k].shape == dst[k].shape for k in src):
        dist.load_state_dict(src)
    elif src:
        logger.warning(
            "%s: the tensors of %s do not map by name onto %s, which starts from its own init "
            "(load the weights after distribution; an HF model loads through smp.from_hf).",
            path or "<root>", type(orig).__name__, type(dist).__name__)


def distribute_tree(module, mm=None, registry=None):
    """``(module, replaced paths)``: ``module`` with its tp-marked registered
    modules distributed (the root included, as ``"<root>"``), partition
    stamps recorded in ``mm`` and its activation-checkpoint configs applied."""
    from smdistributed_modelparallel_tpu_torch.nn.transformer import refuse_tp

    replaced = []

    def walk(mod, path):
        part = mod.__dict__.get(_PARTITION_MARK)
        if part is not None and mm is not None:
            mm.set_partition(path, part)
        cfg = _tp_config(mod, path, mm)
        if cfg is not None and registry is not None and registry.is_supported(type(mod)):
            refuse_tp("a module marked for tensor parallelism (smp.tensor_parallelism, "
                      "smp.set_tensor_parallelism; the tp config and _match_weights against sharded weights)")
            ctor = mod.__dict__.get(_CTOR)
            if ctor is None:
                raise TensorParallelismError(
                    f"{path or 'the model'} ({type(mod).__name__}) is marked for tensor parallelism but was built "
                    "before its class was registered; build it after smp.init."
                )
            dist = registry.distribute(type(mod), *ctor, tp_config=cfg)
            if dist is not None:
                _carry_values(mod, dist, path)
                replaced.append(path or "<root>")
                return dist
        if not type(mod).__module__.startswith(_NN_PACKAGE):
            for name, child in list(mod.named_children()):
                new = walk(child, f"{path}/{name}" if path else name)
                if new is not child:
                    setattr(mod, name, new)
        return mod

    module = walk(module, "")
    if replaced:
        logger.info("Distributed %d tp-marked module(s): %s", len(replaced), replaced)
    _apply_checkpoint_configs(module, mm)
    return module, replaced


def _apply_checkpoint_configs(root, mm):
    """Turn on ``activation_checkpointing`` of every module under ``root``
    that has the flag and that a config registered with
    ``smp.set_activation_checkpointing`` touches: its path (the torch
    attribute names joined by '/'), "" (every module), an ancestor or a
    descendant. The root's path is "", so any config turns on the LM head's
    flag, which is its stack's, as the flax field reaches the stack."""
    if mm is None or not mm.checkpoint_configs:
        return
    for name, mod in root.named_modules():
        if hasattr(mod, "activation_checkpointing") and _ckpt_config_touches(mm, name.replace(".", "/")):
            mod.activation_checkpointing = True


def _ckpt_config_touches(mm, path):
    """True if any activation-checkpoint config targets ``path``, one of its
    ancestors, or one of its descendants."""
    for prefix in mm.checkpoint_configs:
        if (prefix == path or prefix == "" or path == "" or path.startswith(prefix + "/")
                or prefix.startswith(path + "/")):
            return True
    return False


# The built-in registrations (reference torch/tp_registry.py:16-19).


def _linear_init_hook(in_features, out_features, bias=True, device=None, dtype=None):
    return (in_features, out_features), {"bias": bias, "device": device, "dtype": dtype}


def _embedding_init_hook(num_embeddings, embedding_dim, padding_idx=None, max_norm=None, norm_type=2.0,
                         scale_grad_by_freq=False, sparse=False, _weight=None, _freeze=False, device=None,
                         dtype=None):
    """DistributedEmbedding is a plain table lookup: an embedding with a
    padding row, a max norm, frequency-scaled or sparse gradients or a frozen
    table keeps ``nn.Embedding``."""
    if padding_idx is not None or max_norm is not None or scale_grad_by_freq or sparse or _freeze:
        logger.info("nn.Embedding with padding_idx/max_norm/scale_grad_by_freq/sparse/_freeze stays undistributed.")
        return None
    return (num_embeddings, embedding_dim), {"device": device, "dtype": dtype}


def register_builtins(registry):
    from smdistributed_modelparallel_tpu_torch.nn.embedding import DistributedEmbedding
    from smdistributed_modelparallel_tpu_torch.nn.linear import DistributedLinear

    if not registry.is_supported(nn.Linear):
        registry.register(nn.Linear, DistributedLinear, init_hook=_linear_init_hook)
    if not registry.is_supported(nn.Embedding):
        registry.register(nn.Embedding, DistributedEmbedding, init_hook=_embedding_init_hook)
