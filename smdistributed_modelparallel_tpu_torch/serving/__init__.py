"""``smp.serving``: the continuous-batching serving engine on one device.

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

The multi-process tier (``ReplicatedServingEngine``, the request router, the
serving control plane) needs processes and the message bus; its names raise
``NotImplementedError`` until slice 3b (ROADMAP item 5b) ports them.
"""

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

# The JAX package's replica.py, router.py and controller.py.
_SLICE_3 = frozenset({
    "AutoscalePolicy", "LocalReplicaHandle", "ROUTER_TX", "RemoteReplicaHandle", "ReplicaServer",
    "ReplicatedServingEngine", "RequestRouter", "SERVE_MIRROR_TX", "ServingController", "controller",
    "replica", "router",
})


def __getattr__(name):
    if name in _SLICE_3:
        raise NotImplementedError(
            f"smp.serving.{name} (replica failover, request routing, the serving control plane) needs "
            "processes and the message bus; it is not ported to PyTorch yet (slice 3b, ROADMAP item 5b)."
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BlockAllocator",
    "ServeRequest",
    "ServingEngine",
    "block_tokens",
    "prefill_chunk_tokens",
    "serve_request_from_record",
    "serve_request_to_record",
    "serve_slots",
]
