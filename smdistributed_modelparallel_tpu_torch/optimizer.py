"""``smp.DistributedOptimizer`` of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/optimizer.py`` on one
device. The JAX package wraps an ``optax.GradientTransformation``; this
package wraps a ``torch.optim.Optimizer`` built over the model's (fp32
master) parameters, as the reference SMP wraps torch optimizers.
``step()`` consumes the gradients that the last ``@smp.step`` call left on
the model: it clips them by their global norm when ``grad_clip_norm`` is
set (optax's formula), skips the update and backs the loss scale off when
an fp16 step overflowed, and otherwise installs them as ``.grad`` and runs
the wrapped optimizer.

Parity note: ``optax.adamw`` defaults to ``weight_decay=1e-4`` and
``torch.optim.AdamW`` to ``1e-2``; pass ``weight_decay=1e-4, eps=1e-8`` to
train as the JAX package's ``optax.adamw(lr)`` does.

Checkpoints. ``state_dict()`` is torch's own. The checkpoint files hold the
JAX package's optax layout instead, so that either package resumes the
other's runs; two torch optimizers have a map to it:
  - ``torch.optim.AdamW`` <-> ``optax.adamw``;
  - ``torch.optim.Adam`` with ``weight_decay=0`` <-> ``optax.adam``;
each with ``amsgrad=False`` and ``maximize=False``. Both optax chains start
with ``scale_by_adam``, whose state is ``ScaleByAdamState(count, mu, nu)``;
the rest of the chain holds no array. So the layout is ``0/count`` (int32,
torch's per-parameter ``step``, equal for every parameter), ``0/mu/<key>``
(``exp_avg``) and ``0/nu/<key>`` (``exp_avg_sq``), the moments in the
model's reference layout (``DistributedModel.reference_state_dict``: layers
stacked, kernels [in, out]). The hyperparameters are not part of optax's
state: a resumed run builds its optimizer with the same ones.
``reference_state_dict()`` gives that flat dict, ``local_state_dict()`` it
as a shard payload, and ``load_state_dict`` takes torch's dict, a
reference-keyed flat dict or a shard payload. Another optimizer trains, but
saving or loading it in that layout raises ``SMPValidationError``. A
checkpoint that ``smp.resume_from_checkpoint`` read before the optimizer
existed is applied when it is built.

Under ``SMP_HEALTH_CHECK`` a step that updates records the gradient,
parameter and update norm gauges (``health.record_update_stats``; every 16th
step in ``cheap``, with an asynchronous readback, every step in ``full``).
The update norm needs the parameters from before the in-place update: on
those steps only, a copy of them is kept across the update.
"""

import collections

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.convert import to_numpy
from smdistributed_modelparallel_tpu_torch.module_manager import path_key, tree_flatten_with_path
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPValidationError,
    StepUsageError,
)
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils import health, profiling

logger = get_logger()

# optax's scale_by_adam state (optax.ScaleByAdamState): the field order is
# the order of its checkpoint keys.
_AdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
_MAPPED = "torch.optim.AdamW (optax.adamw), torch.optim.Adam with weight_decay=0 (optax.adam)"


def _maps_to_optax(optimizer):
    """True for ``torch.optim.AdamW`` and for ``torch.optim.Adam`` without
    weight decay, neither with ``amsgrad`` or ``maximize``."""
    groups = optimizer.param_groups
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)) or any(
            g.get("amsgrad") or g.get("maximize") for g in groups):
        return False
    return isinstance(optimizer, torch.optim.AdamW) or all(
        g.get("decoupled_weight_decay") or g.get("weight_decay", 0) == 0 for g in groups)


def _adam_prefix(keys):
    """The path of the scale_by_adam state among reference keys (``"0/"``
    in an optax chain)."""
    keys = list(keys)
    for k in keys:
        if k.endswith("count"):
            prefix = k[: -len("count")]
            if any(x.startswith(prefix + "mu/") for x in keys):
                return prefix
    raise SMPValidationError("The optimizer state holds no optax scale_by_adam state (count, mu, nu).")


class DistributedOptimizer:
    """Args:
      optimizer: a ``torch.optim.Optimizer`` over ``model.parameters()``.
      model: the ``DistributedModel`` (default: the last one created).
      grad_clip_norm: clip the gradients to this global L2 norm.
    """

    def __init__(self, optimizer, model=None, grad_clip_norm=None):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise SMPValidationError(
                "DistributedOptimizer expects a torch.optim.Optimizer "
                f"(got {type(optimizer).__name__})."
            )
        self.optimizer = optimizer
        self.model = model if model is not None else state.model
        if self.model is None:
            raise SMPValidationError("Create smp.DistributedModel before the optimizer.")
        self.grad_clip_norm = grad_clip_norm
        state.optimizer = self
        if state.loaded_optimizer_state is not None:
            from smdistributed_modelparallel_tpu_torch.shard_io import ShardCatalog

            logger.info("Applying deferred checkpoint state to optimizer.")
            payload, state.loaded_optimizer_state = state.loaded_optimizer_state, None
            if isinstance(payload, ShardCatalog):
                self.load_sharded(payload)
            else:
                self.load_state_dict(payload)

    def step(self):
        """Apply the gradients of the last ``@smp.step`` call (the profiler
        region ``optimizer/step``)."""
        with profiling.region("optimizer/step"):
            self._step_impl()

    def _step_impl(self):
        model = self.model
        grads = model._grads
        if grads is None:
            raise StepUsageError(
                "No gradients available: run an @smp.step function with "
                "model.backward(loss) before optimizer.step()."
            )
        model._dropped_updates = 0  # the loop does call optimizer.step()
        scaler = state.loss_scaler
        finite = model._grads_finite
        model._grads = None
        model._grads_finite = None
        if finite is not None and not finite:
            # Overflow under fp16 loss scaling: skip the update and back the
            # scale off.
            if scaler is not None:
                scaler.update(True)
            return
        consumed = grads
        if self.grad_clip_norm is not None:
            gnorm = _global_norm(model, grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-6), max=1.0)
            grads = {n: g * scale.to(g.dtype) for n, g in grads.items()}
        params = dict(model.module.named_parameters())
        # The update-ratio gauge needs the pre-update parameters, which the
        # in-place update overwrites: a snapshot on the sampled steps only,
        # as the JAX package's fused step retains its input tree (not under
        # fused_step_donation, which donates it).
        old = None
        if health.enabled() and health.update_stats_due() and state.cfg.fused_optimizer_step \
                and not state.cfg.fused_step_donation:
            old = [p.detach().clone() for p in params.values()]
        for name, g in grads.items():
            params[name].grad = g
        self.optimizer.step()
        for name in grads:
            params[name].grad = None
        model._param_version += 1
        if health.enabled():
            health.record_update_stats(model, old, list(params.values()), grads=list(consumed.values()))
        if scaler is not None:
            scaler.update(False)

    def zero_grad(self):
        self.model._grads = None
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self):
        """torch's ``state_dict`` of the wrapped optimizer."""
        return self.optimizer.state_dict()

    @property
    def has_state(self):
        """True once the wrapped optimizer holds state (after its first
        step or a load)."""
        return bool(self.optimizer.state)

    def _check_mapped(self):
        if not _maps_to_optax(self.optimizer):
            raise SMPValidationError(
                f"{type(self.optimizer).__name__} has no map to the JAX package's optax state; the "
                f"optimizers that have one: {_MAPPED}, each with amsgrad=False and maximize=False."
            )

    def reference_state_dict(self):
        """Host copy of the state in the JAX package's optax layout: a flat
        dict with ``0/count``, ``0/mu/<key>`` and ``0/nu/<key>`` (the
        ``optimizer`` entry of a full checkpoint). A parameter without state
        yet has zero moments."""
        self._check_mapped()
        count, mu, nu = 0, {}, {}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            if "exp_avg" in st:
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
                count = max(count, int(st["step"]))
            else:
                mu[name] = nu[name] = torch.zeros_like(p)
        to_ref = self.model._to_reference
        tree = (_AdamState(np.asarray(count, np.int32), to_ref(mu), to_ref(nu)),)  # optax's chain: 0/...
        return {path_key(path): leaf for path, leaf in tree_flatten_with_path(tree)}

    def local_state_dict(self):
        """This rank's shard payload of ``reference_state_dict()``,
        round-trippable through ``load_state_dict``."""
        from smdistributed_modelparallel_tpu_torch.shard_io import shard_payload

        return shard_payload(self.reference_state_dict(), dedupe_global=False)

    def load_state_dict(self, state_dict):
        """Load torch's ``state_dict``, a reference-keyed flat dict or a
        shard payload."""
        from smdistributed_modelparallel_tpu_torch.shard_io import InMemoryCatalog, is_shard_payload

        if is_shard_payload(state_dict):
            self.load_sharded(InMemoryCatalog(state_dict))
        elif "state" in state_dict and "param_groups" in state_dict:
            self.optimizer.load_state_dict(state_dict)
        else:
            self._load_reference(state_dict)

    def load_sharded(self, catalog):
        """Load a ``shard_io`` catalog of the optax layout."""
        try:
            self._check_mapped()
            loaded = catalog.load_tree(device=self.model.device)
        finally:
            catalog.close()
        self._load_reference(loaded)

    def _load_reference(self, flat):
        """Install optax's (count, mu, nu) from a reference-keyed flat dict
        as the wrapped optimizer's (step, exp_avg, exp_avg_sq): the moments
        are copied into tensors laid out as their parameters, then go
        through torch's own ``load_state_dict`` (which places ``step`` as the
        optimizer keeps it). A parameter the dict lacks keeps its state."""
        self._check_mapped()
        prefix = _adam_prefix(flat)
        count = float(to_numpy(flat[prefix + "count"]))
        moments = {}
        for m in ("mu", "nu"):
            start = f"{prefix}{m}/"
            moments[m] = self.model._from_reference({k[len(start):]: v for k, v in flat.items()
                                                    if k.startswith(start)})
        names = {p: n for n, p in self.model.named_parameters()}
        sd = self.optimizer.state_dict()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for idx, p in enumerate(params):
            name = names.get(p)
            if name in moments["mu"] and name in moments["nu"]:
                sd["state"][idx] = {"step": torch.tensor(count, dtype=torch.float32),
                                    **{k: torch.empty_like(p).copy_(moments[m][name])
                                       for k, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}}
        self.optimizer.load_state_dict(sd)


def _global_norm(model, grads):
    """The L2 norm of the step's gradients over the whole model: at ep > 1
    an ep rank holds a slice of the experts, at tp > 1 a slice of every
    tp-sharded parameter, at pp > 1 its stage's layers, so their squares are
    summed over the ep (tp, pp) group (each shard counted once) before the
    root; a replicated parameter counts once."""
    experts, sharded, layers = model._expert_params, model._tp_specs, model._pp_layer_params
    if not experts and not sharded and not layers:
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    from smdistributed_modelparallel_tpu_torch.backend.topology import EP_AXIS, PP_AXIS, TP_AXIS

    if layers:
        zero = torch.zeros((), device=next(iter(grads.values())).device)
        stage = sum(((g.float() ** 2).sum() for n, g in grads.items() if n in layers), zero).reshape(1)
        state.group(PP_AXIS).all_reduce(stage)
        return torch.sqrt(sum(((g.float() ** 2).sum() for n, g in grads.items() if n not in layers), zero)
                          + stage[0])

    zero = torch.zeros((), device=next(iter(grads.values())).device)
    total = sum(((g.float() ** 2).sum() for n, g in grads.items() if n not in experts and n not in sharded), zero)
    for names, axis in ((experts, EP_AXIS), (sharded, TP_AXIS)):
        if names:
            shards = sum(((g.float() ** 2).sum() for n, g in grads.items() if n in names), zero).reshape(1)
            state.group(axis).all_reduce(shards)
            total = total + shards[0]
    return torch.sqrt(total)
