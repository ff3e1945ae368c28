"""``smp.serving``: the continuous-batching serving engine and its control plane.

Counterpart of ``smdistributed_modelparallel_tpu/serving``: a paged KV cache
shared by every sequence in flight, a continuous-batching scheduler with
chunked prefill, and restartable requests (``serving/engine.py``,
``serving/kv_cache.py``).

    engine = smp.serving.ServingEngine(model)   # or (module, params=...)
    results = engine.run([
        smp.serving.ServeRequest("r0", prompt_ids, max_new_tokens=64),
        smp.serving.ServeRequest("r1", other_ids, max_new_tokens=8,
                                 temperature=0.8, top_p=0.9, seed=7),
    ])

Multi-process deployments wrap the engine in ``ReplicatedServingEngine`` for
mirror-log failover. The serving control plane lives in
``smp.serving.controller`` / ``smp.serving.router``: SLO-driven autoscaling
with hysteresis and cooldown, least-loaded request routing with per-version
traffic splits, the drain protocol, and canaried live weight updates with
rollback. ``SMP_AUTOSCALE`` arms it (``ServingController.from_env()``
returns None when unset). Each is the JAX package's module of the same name,
over the native host bus (``serving/replica.py``, ``router.py``,
``controller.py``).
"""

from smdistributed_modelparallel_tpu_torch.serving import controller, router
from smdistributed_modelparallel_tpu_torch.serving.controller import AutoscalePolicy, ServingController
from smdistributed_modelparallel_tpu_torch.serving.engine import (
    ServeRequest,
    ServingEngine,
    serve_request_from_record,
    serve_request_to_record,
)
from smdistributed_modelparallel_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    block_tokens,
    prefill_chunk_tokens,
    serve_slots,
)
from smdistributed_modelparallel_tpu_torch.serving.replica import SERVE_MIRROR_TX, ReplicatedServingEngine
from smdistributed_modelparallel_tpu_torch.serving.router import (
    ROUTER_TX,
    LocalReplicaHandle,
    RemoteReplicaHandle,
    ReplicaServer,
    RequestRouter,
)

__all__ = [
    "AutoscalePolicy",
    "BlockAllocator",
    "LocalReplicaHandle",
    "ROUTER_TX",
    "RemoteReplicaHandle",
    "ReplicaServer",
    "ReplicatedServingEngine",
    "RequestRouter",
    "SERVE_MIRROR_TX",
    "ServeRequest",
    "ServingController",
    "ServingEngine",
    "block_tokens",
    "controller",
    "prefill_chunk_tokens",
    "router",
    "serve_request_from_record",
    "serve_request_to_record",
    "serve_slots",
]
