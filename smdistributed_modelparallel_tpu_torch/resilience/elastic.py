"""Elastic resume: a checkpoint saved under another degree layout.

Counterpart of ``smdistributed_modelparallel_tpu/resilience/elastic.py``
(``classify_mismatches``, ``begin_elastic_resume``). The reference SMP
refuses a partial checkpoint whose (pp, tp, rdp) layout differs from the
live one (``verify_smp_config``); the shard files of both packages key
every piece by its logical path and global bounds, not by rank coordinates,
so a resume under another layout reassembles each leaf from the pieces that
cover it (``shard_io``). This module classifies the mismatches and logs the
transition; ``resume_from_checkpoint`` calls it where ``verify_smp_config``
would have raised. The port assembles every leaf whole and, at tp > 1, each
rank keeps its part of it (``DistributedModel``); pp > 1 on the port's side
arrives with its slice.
"""

from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_elastic_resume

logger = get_logger()

# Degree/layout keys: a mismatch here changes where state lives.
LAYOUT_KEYS = (
    "pipeline_parallel_degree",
    "tensor_parallel_degree",
    "sharded_data_parallel_degree",
    "sharded_params",
    "shard_optimizer_state",
)

# Soft keys: they change neither the tree's structure nor its logical
# shapes; the writer census and step edge of the checkpoint's snapshot too.
SOFT_KEYS = (
    "microbatches",
    "optimize",
    "prescaled_batch",
    "num_processes",
    "step_count",
)


def classify_mismatches(saved, current):
    """Split saved-vs-current config mismatches into (layout, soft, other)
    dicts of ``key -> (saved_value, current_value)``."""
    layout, soft, other = {}, {}, {}
    for k in set(saved) | set(current):
        if k not in saved or k not in current or saved[k] == current[k]:
            continue
        entry = (saved[k], current[k])
        if k in LAYOUT_KEYS:
            layout[k] = entry
        elif k in SOFT_KEYS:
            soft[k] = entry
        else:
            other[k] = entry
    return layout, soft, other


def describe_state_layout(cfg_like):
    """Where optimizer and parameter state lives under a config (a live
    ``ModelParallelConfig`` or a saved snapshot dict), for the log."""
    if hasattr(cfg_like, "get"):
        get = cfg_like.get
    else:
        def get(k, d=None):
            return getattr(cfg_like, k, d)

    rdp = int(get("sharded_data_parallel_degree", 0) or 0)
    sharded_params = str(get("sharded_params", "none") or "none")
    return {
        "zero1": bool(get("shard_optimizer_state", False)),
        "zero2d": rdp > 1,
        "zero3": sharded_params == "zero3",
        "sharded_params": sharded_params,
        "sharded_data_parallel_degree": rdp,
        "pipeline_parallel_degree": int(get("pipeline_parallel_degree", 1) or 1),
        "tensor_parallel_degree": int(get("tensor_parallel_degree", 1) or 1),
    }


def begin_elastic_resume(saved_cfg, current_cfg, shard_format, what=""):
    """Authorize a topology-mismatched resume: raise ``SMPValidationError``
    when the format cannot reshard (the legacy per-rank pickle layout),
    else log the transition and return ``(layout, soft)``."""
    layout, soft, other = classify_mismatches(saved_cfg, current_cfg)
    if not shard_format:
        raise SMPValidationError(
            "Elastic resume needs a reshardable checkpoint format (per-leaf "
            "shard catalogs or a full gathered state dict); this checkpoint "
            "uses the legacy per-rank pickle layout, whose fragments are "
            f"welded to the saved topology. Mismatches: {dict(layout, **soft)}"
        )
    logger.warning(
        "ELASTIC RESUME %s: checkpoint topology differs from the live "
        "config — resharding per-leaf from logical bounds. Degree/layout "
        "mismatches: %s; soft mismatches: %s; optimizer-state layout: "
        "%s -> %s.",
        what, layout or "{}", soft or "{}", describe_state_layout(saved_cfg), describe_state_layout(current_cfg),
    )
    if other:
        logger.warning(
            "elastic resume: non-topology config keys also differ (not "
            "verified, not resharded — make sure this is intended): %s",
            other,
        )
    record_elastic_resume(len(layout), len(soft), detail=f"layout={layout} soft={soft}")
    return layout, soft
