"""The tensor-parallelism registry: module classes and their distributed
counterparts.

Counterpart of ``smdistributed_modelparallel_tpu/nn/tp_registry.py``:
``register`` maps an original class to its distributed class with an init
hook (the original's constructor arguments -> the distributed class's, or
None to decline and leave the module as it is), a forward hook (the
original's call arguments -> the distributed module's) and a return hook
(its output -> the original's), plus ``translate_functions`` (to_hf,
from_hf) keyed by the distributed class; ``smp.tp_register`` and
``smp.tp_register_with_module`` fill the live registry.

Registering a class also wraps its ``__init__`` (``nn/auto_distribute.
record_construction``): each instance built afterwards keeps its constructor
arguments, which ``distribute`` re-reads, and the marks of an active
``smp.tensor_parallelism()`` or ``smp.partition()`` context. This is the
reference's ``patch_constructor`` design; the JAX package reads a flax
module's dataclass fields instead.
"""

from smdistributed_modelparallel_tpu_torch.utils.exceptions import TensorParallelismError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


class TensorParallelismRegistry:
    def __init__(self):
        # original class -> (distributed class, init_hook, forward_hook, return_hook)
        self._map = {}
        self._translate_functions = {}  # distributed class -> (to_hf, from_hf)

    def register(self, origin_cls, dist_cls, init_hook=None, forward_hook=None, return_hook=None,
                 translate_functions=None):
        from smdistributed_modelparallel_tpu_torch.nn.auto_distribute import record_construction

        if origin_cls in self._map:
            logger.debug("Overwriting tp registration for %s", origin_cls.__name__)
        record_construction(origin_cls)
        self._map[origin_cls] = (dist_cls, init_hook, forward_hook, return_hook)
        if translate_functions is not None:
            self._translate_functions[dist_cls] = translate_functions

    def is_supported(self, origin_cls):
        return origin_cls in self._map

    def distributed_class(self, origin_cls):
        try:
            return self._map[origin_cls][0]
        except KeyError:
            raise TensorParallelismError(
                f"{origin_cls.__name__} has no registered distributed counterpart; "
                "use smp.tp_register / smp.tp_register_with_module."
            ) from None

    def hooks(self, origin_cls):
        _, init_hook, forward_hook, return_hook = self._map[origin_cls]
        return init_hook, forward_hook, return_hook

    def distribute(self, origin_cls, args, kwargs, tp_config=None):
        """Build the distributed counterpart of ``origin_cls(*args,
        **kwargs)``, with ``tp_config`` added to its keyword arguments.

        Returns None when the init hook declines. Forward and return hooks
        run around the module's own forward (torch's forward pre-hook and
        forward hook), so its parameter names stay those of the distributed
        class, as the JAX package's scope-sharing ``HookedModule`` keeps
        them."""
        dist_cls, init_hook, forward_hook, return_hook = self._map[origin_cls]
        if init_hook is not None:
            hooked = init_hook(*args, **kwargs)
            if hooked is None:
                return None
            args, kwargs = hooked
        kwargs = dict(kwargs)
        if tp_config:
            kwargs.update(tp_config)
        module = dist_cls(*args, **kwargs)
        if forward_hook is not None or return_hook is not None:
            from smdistributed_modelparallel_tpu_torch.nn.auto_distribute import attach_hooks

            attach_hooks(module, forward_hook, return_hook)
        return module

    def translate_functions(self, dist_cls):
        return self._translate_functions.get(dist_cls)


def _live_registry():
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    if state.tp_registry is None:
        state.tp_registry = TensorParallelismRegistry()
    return state.tp_registry


def tp_register(origin_cls, init_hook=None, forward_hook=None, return_hook=None, translate_functions=None):
    """Decorator form: ``@smp.tp_register(nn.Linear, ...) class DistLinear``."""

    def wrap(dist_cls):
        _live_registry().register(origin_cls, dist_cls, init_hook, forward_hook, return_hook, translate_functions)
        return dist_cls

    return wrap


def tp_register_with_module(origin_cls, dist_cls, init_hook=None, forward_hook=None, return_hook=None,
                            translate_functions=None):
    """Function form of ``tp_register``."""
    _live_registry().register(origin_cls, dist_cls, init_hook, forward_hook, return_hook, translate_functions)
