"""Pipeline auto-partitioner entry point.

Counterpart of ``smdistributed_modelparallel_tpu/parallel/partition.py``:
``maybe_auto_partition`` assigns the layers to pipeline stages
(``parallel/pipeline.partition_for_pipeline``), or reuses a saved assignment
(``load_partition`` with ``partition_file``), writes it (``partition_file``
alone, rank 0 only), installs it in the module manager and returns it.
``DistributedModel`` calls it when it is built. ZeRO's 2-D registration
(``maybe_register_zero2d``) waits for the ZeRO slice (ROADMAP item 9), whose
``sharded_params`` the step refuses.
"""

import json
import os

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import PartitionError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()


def maybe_auto_partition(model):
    """The stage assignment of ``model``: ``{"": 0}`` at pp = 1, else
    ``{"<layer_path>#<i>": stage}``; installed in the module manager."""
    cfg = state.cfg
    if cfg.pipeline_parallel_degree == 1:
        assignment = {"": 0}
    else:
        from smdistributed_modelparallel_tpu_torch.parallel.pipeline import partition_for_pipeline

        assignment = _maybe_load_partition(model)
        if assignment is None:
            assignment = partition_for_pipeline(model)
            _maybe_save_partition(assignment)
    model.module_manager.set_partition_assignment(assignment)
    return assignment


def _maybe_load_partition(model):
    """``load_partition`` + ``partition_file``: reuse a saved stage
    assignment, re-validated against the model's layer count and layer
    path, then installed through the pin path the manual partitioner uses."""
    from smdistributed_modelparallel_tpu_torch.parallel.pipeline import get_pipeline_spec, partition_for_pipeline

    cfg = state.cfg
    if not cfg.load_partition:
        return None
    path = cfg.partition_file
    if not path or not os.path.exists(path):
        raise PartitionError(f"load_partition: True but partition_file not found: {path!r}")
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    if payload.get("pipeline_parallel_degree") != cfg.pipeline_parallel_degree:
        raise PartitionError(
            "partition_file was saved for pipeline_parallel_degree="
            f"{payload.get('pipeline_parallel_degree')}, current is "
            f"{cfg.pipeline_parallel_degree}."
        )
    assignment = {k: int(v) for k, v in payload["assignment"].items()}
    spec = get_pipeline_spec(model.module)
    if spec is not None:
        saved_layers = payload.get("num_layers")
        if saved_layers is not None and saved_layers != spec.num_layers:
            raise PartitionError(
                f"partition_file was saved for {saved_layers} layers, the "
                f"current model has {spec.num_layers}."
            )
        bad = [k for k in assignment if not k.startswith(spec.layer_path + "#")]
        if bad:
            raise PartitionError(
                f"partition_file entries {bad[:3]}... do not match the "
                f"current model's layer path '{spec.layer_path}'."
            )
    for prefix, stage in assignment.items():
        model.module_manager.set_partition(prefix, stage)
    out = partition_for_pipeline(model)
    logger.info("Loaded pipeline partition from %s.", path)
    return out


def _maybe_save_partition(assignment):
    cfg = state.cfg
    path = cfg.partition_file
    if not path or cfg.load_partition or state.rank != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    num_layers = None
    if assignment:
        try:
            num_layers = max(int(k.rsplit("#", 1)[1]) for k in assignment) + 1
        except (ValueError, IndexError):
            num_layers = None
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({
            "pipeline_parallel_degree": cfg.pipeline_parallel_degree,
            "num_layers": num_layers,
            "assignment": assignment,
        }, fh, indent=1)
    logger.info("Saved pipeline partition to %s.", path)
