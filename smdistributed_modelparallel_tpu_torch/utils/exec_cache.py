"""The shape-bucket policy of ``SMP_SHAPE_BUCKETS``.

Counterpart of the bucket policy in
``smdistributed_modelparallel_tpu/utils/exec_cache.py`` (``bucket_policy``,
``bucket_for``). The JAX package buckets shapes so that ragged calls reuse one
compiled program; ``smp.generate`` reads the "seq" sizes to round the decode
length up (and, for a module that takes ``attention_mask``, to left-pad the
prompt). The port compiles nothing, but it keeps the policy so that a bucketed
run gives the JAX package's tokens: sampling draws from the bucketed key
schedule. ``record_bucket`` counts each bucketing outcome
(``smp_shape_bucket_total``). The executable cache itself (the AOT store)
waits for its own slice.

``compile_event_mark`` / ``compile_events_since`` keep the JAX package's
compile-event ledger interface over the port's compiles: the first load of a
kernel library in the process (``ops/_build.load``), ``"fresh"`` when ``nvcc``
built it, ``"disk_cache"`` when it was on disk. The serving control plane
reads them to show a warm scale-up (``fresh == 0``).
"""

import os

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

logger = get_logger()

BUCKETS_ENV = "SMP_SHAPE_BUCKETS"

_policy_cache = {}


def bucket_policy():
    """Parse ``SMP_SHAPE_BUCKETS`` into ``{"batch": [...], "seq": [...],
    "seq_pad": int}`` (ascending, deduped), or None when unset or empty.
    A malformed spec logs once and disables bucketing rather than raise."""
    spec = os.environ.get(BUCKETS_ENV, "").strip()
    if not spec:
        return None
    cached = _policy_cache.get(spec)
    if cached is not None:
        return cached or None
    policy = {"seq_pad": 0}
    try:
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seq_pad="):
                policy["seq_pad"] = int(part.split("=", 1)[1])
                continue
            dim, _, vals = part.partition(":")
            dim = dim.strip()
            if dim not in ("batch", "seq") or not vals:
                raise ValueError(f"unknown bucket spec part {part!r}")
            sizes = sorted({int(v) for v in vals.split(",") if v.strip()})
            if not sizes or any(s <= 0 for s in sizes):
                raise ValueError(f"bad bucket sizes in {part!r}")
            policy[dim] = sorted(set(policy.get(dim, [])) | set(sizes))
    except (ValueError, TypeError) as e:
        logger.warning("[exec_cache] malformed %s=%r (%s); shape bucketing disabled.", BUCKETS_ENV, spec, e)
        _policy_cache[spec] = False
        return None
    if "batch" not in policy and "seq" not in policy:
        _policy_cache[spec] = False
        return None
    _policy_cache[spec] = policy
    return policy


def bucket_for(n, sizes):
    """Smallest bucket >= n, or None (n exceeds every bucket: the shape
    stays exact)."""
    for s in sizes:
        if s >= int(n):
            return int(s)
    return None


def record_bucket(result):
    telemetry.counter(
        "smp_shape_bucket_total",
        "shape-bucketing decisions by outcome "
        "(exact / padded / unbucketable)",
    ).labels(result=result).inc()


def compile_event_mark():
    """A position in the process's compile-event ledger."""
    from smdistributed_modelparallel_tpu_torch.ops._build import COMPILE_EVENTS

    return len(COMPILE_EVENTS)


def compile_events_since(mark):
    """The compile events (``{"source", "name", "seconds"}``) recorded
    after ``mark``."""
    from smdistributed_modelparallel_tpu_torch.ops._build import COMPILE_EVENTS

    return list(COMPILE_EVENTS[mark:])
