"""The host surface of the PyTorch port: rank and group queries, the world
barrier and the exit-status relay.

Counterpart of ``smdistributed_modelparallel_tpu/backend/core.py``
(``ModelParallelCore``). The JAX package drives several devices from one
process and answers a device-level query for a device index (by default the
process's first device). The port runs one process a device, so a process
rank is a device rank: each query answers for this process unless it is
given a ``device_index``, and the answers come from the same ``Ranker``
arithmetic over the same placement.

- ``rank``/``size``, ``pp_/tp_/rdp_/dp_/mp_/cp_/ep_rank`` and ``_size``, as
  the JAX package defines them: ``rdp_size`` is the reference's D dimension
  (rdp x cp x ep), ``dp_size`` tp x D, ``mp_size`` pp x tp;
- ``*_rank_to_rank``: the world rank that holds a coordinate on one axis
  and this rank's coordinates on the others;
- ``get_*_group``: the world ranks of this rank's group along an axis;
- ``local_size``, ``instance_id``, ``is_in_same_instance``,
  ``is_multi_node``: an instance is a host. ``smp.init`` gathers every
  rank's host name (``state.hosts``); ``instance_id(rank)`` numbers the
  hosts in the order of their first rank;
- ``barrier()``: the world barrier, over the native bus at world > 1;
- ``relay_exit_status(success)``: at ``smp.shutdown`` every rank but 0
  sends rank 0 its exit status on tx -1 and rank 0 logs the failures, for at
  most two seconds; then the bus closes. It runs before the bus closes,
  which is why ``state.shutdown`` owns closing a multi-process bus.
"""

import time

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.backend.topology import CP_AXIS
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

EXIT_STATUS_TX = -1

# Rank 0's view of the last exit-status relay: {"failed": [...], "silent":
# [...]} (ranks that reported failure, ranks that sent nothing in time).
last_exit_report = None


def _topology():
    state.check()
    return state.topology


def rank(device_index=None):
    state.check()
    return state.rank if device_index is None else device_index


def size():
    return _topology().size


def local_rank():
    state.check()
    return state.local_rank


def local_size():
    """The number of ranks on this rank's host."""
    state.check()
    hosts = state.hosts or [None]
    return hosts.count(hosts[state.rank]) if len(hosts) > state.rank else 1


def pp_rank(device_index=None):
    return _topology().ranker.get_pp_rank(rank(device_index))


def tp_rank(device_index=None):
    return _topology().ranker.get_tp_rank(rank(device_index))


def rdp_rank(device_index=None):
    return _topology().ranker.get_rdp_rank(rank(device_index))


def dp_rank(device_index=None):
    return _topology().ranker.get_dp_rank(rank(device_index))


def mp_rank(device_index=None):
    return _topology().ranker.get_mp_rank(rank(device_index))


def cp_rank(device_index=None):
    return _topology().cp_rank(rank(device_index))


def pp_size():
    return _topology().pp_size


def tp_size():
    return _topology().tp_size


def rdp_size():
    return _topology().d_size


def dp_size():
    return _topology().dp_size


def mp_size():
    t = _topology()
    return t.pp_size * t.tp_size


def cp_size():
    return _topology().cp_size


def ep_size():
    return _topology().ep_size


def _in_range(value, n, name):
    """Reject a negative or too large coordinate: an index that wrapped
    would name the wrong peer of a collective."""
    if not 0 <= value < n:
        raise SMPValidationError(f"{name} {value} out of range [0, {n}).")


def pp_rank_to_rank(pp_rank_):
    """World rank of pipeline stage ``pp_rank_`` in this rank's tp x rdp
    coordinates."""
    _in_range(pp_rank_, pp_size(), "pp_rank")
    rk, me = state.topology.ranker, state.rank
    return rk.translate(pp_rank=pp_rank_, tp_rank=rk.get_tp_rank(me), rdp_rank=rk.get_rdp_rank(me))


def tp_rank_to_rank(tp_rank_):
    _in_range(tp_rank_, tp_size(), "tp_rank")
    rk, me = state.topology.ranker, state.rank
    return rk.translate(pp_rank=rk.get_pp_rank(me), tp_rank=tp_rank_, rdp_rank=rk.get_rdp_rank(me))


def rdp_rank_to_rank(rdp_rank_):
    _in_range(rdp_rank_, rdp_size(), "rdp_rank")
    rk, me = state.topology.ranker, state.rank
    return rk.translate(pp_rank=rk.get_pp_rank(me), tp_rank=rk.get_tp_rank(me), rdp_rank=rdp_rank_)


def dp_rank_to_rank(dp_rank_):
    """World rank of composite dp rank ``dp_rank_`` (tp x rdp) in this
    rank's pipeline stage."""
    _in_range(dp_rank_, dp_size(), "dp_rank")
    rk, me = state.topology.ranker, state.rank
    return rk.translate(pp_rank=rk.get_pp_rank(me), tp_rank=rk.get_tp_rank_from_dp_rank(dp_rank_),
                        rdp_rank=rk.get_rdp_rank_from_dp_rank(dp_rank_))


def mp_rank_to_rank(mp_rank_):
    """World rank of composite mp rank ``mp_rank_`` (pp x tp) in this
    rank's rdp coordinate."""
    _in_range(mp_rank_, mp_size(), "mp_rank")
    rk, me = state.topology.ranker, state.rank
    return rk.translate(pp_rank=rk.get_pp_rank_from_mp_rank(mp_rank_), tp_rank=rk.get_tp_rank_from_mp_rank(mp_rank_),
                        rdp_rank=rk.get_rdp_rank(me))


def get_pp_group(device_index=None):
    return _topology().ranker.get_pp_group(rank(device_index))


def get_tp_group(device_index=None):
    return _topology().ranker.get_tp_group(rank(device_index))


def get_rdp_group(device_index=None):
    return _topology().ranker.get_rdp_group(rank(device_index))


def get_dp_group(device_index=None):
    return _topology().ranker.get_dp_group(rank(device_index))


def get_mp_group(device_index=None):
    return _topology().ranker.get_mp_group(rank(device_index))


def get_cp_group(device_index=None):
    return _topology().axis_group(rank(device_index), CP_AXIS)


def get_world_group():
    return _topology().ranker.get_world_group()


def instance_id(rank_=None):
    """The host of rank ``rank_`` (default: this rank), numbered in the
    order of each host's first rank."""
    state.check()
    r = state.rank if rank_ is None else rank_
    hosts = state.hosts or ["localhost"] * state.world_size
    if not 0 <= r < len(hosts):
        raise SMPValidationError(f"rank {r} out of range [0, {len(hosts)}).")
    return list(dict.fromkeys(hosts)).index(hosts[r])


def is_in_same_instance(rank_):
    return instance_id(rank_) == instance_id()


def is_multi_node():
    state.check()
    return len(set(state.hosts or [None])) > 1


def barrier(name="smp_barrier"):
    """The world barrier: every process, over the native bus."""
    state.check()
    state.comm.barrier(name=name)


def relay_exit_status(success):
    """Tell rank 0 how this process ended (tx -1); rank 0 waits at most
    two seconds for the others and logs the ranks that failed. Best effort:
    peers may already be gone. The bus closes afterwards, whatever
    happened."""
    global last_exit_report
    comm = state._comm
    bus = comm.bus if comm is not None else None
    if bus is None:
        return
    try:
        if bus.world > 1:
            if bus.rank != 0:
                bus.send_bytes(0, b"\x01" if success else b"\x00", EXIT_STATUS_TX)
            else:
                failed = [] if success else [0]
                pending = set(range(1, bus.world))
                deadline = time.monotonic() + 2.0
                while pending and time.monotonic() < deadline:
                    for peer in list(pending):
                        if bus.poll(peer, EXIT_STATUS_TX):
                            if bus.recv_bytes(peer, EXIT_STATUS_TX, timeout_ms=0) == b"\x00":
                                failed.append(peer)
                            pending.discard(peer)
                    if pending:
                        time.sleep(0.01)
                last_exit_report = {"failed": sorted(failed), "silent": sorted(pending)}
                if failed:
                    logger.error("shutdown status: process(es) %s reported failure.", sorted(failed))
    except Exception as e:  # never block exit on the relay
        logger.warning("exit-status relay failed: %s", e)
    finally:
        comm.shutdown()
