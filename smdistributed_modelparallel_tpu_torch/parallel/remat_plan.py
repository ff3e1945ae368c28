"""The ``recompute`` knob of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/parallel/remat_plan.py``
(``MODES``, ``ENV``, ``resolve``). The knob (config ``recompute``, env alias
``SMP_RECOMPUTE``) takes "full", "stash_weight", "stash_all" or "auto". In
the JAX package a pipelined run plans which passes stash their residuals
(``plan_pipeline``, ``RecomputePlan``); the port's pipeline keeps each
in-flight microbatch's graph and refuses a plan other than "full" (ROADMAP
item 8). Without a pipeline schedule the knob only chooses what a
checkpointed layer keeps (``parallel/memory.remat_policy``), as it does in
the JAX package at pp = 1.
"""

import os

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

MODES = ("full", "stash_weight", "stash_all", "auto")
ENV = "SMP_RECOMPUTE"


def resolve(cfg=None):
    """The effective knob value: the config's ``recompute``, else
    ``SMP_RECOMPUTE``, else "full" (an unknown value warns and means
    "full")."""
    if cfg is None:
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        cfg = state.cfg
    mode = getattr(cfg, "recompute", None) if cfg is not None else None
    if mode is None:
        mode = os.environ.get(ENV, "full").strip().lower() or "full"
    if mode not in MODES:
        logger.warning("Unknown recompute mode %r; using 'full'.", mode)
        return "full"
    return mode
