"""The port's host control plane and rank surface against the JAX package.

Spawned gloo worlds on the CPU, one per module fixture, each rank running
``smp.init`` (which brings the native bus up over the port's own build of
``native/src/*.cc``):
  - two ranks (rdp = 2), the body of ``tests/test_multiprocess.py::_worker``:
    an object each way, five ordered ``smp.send``/``smp.recv_from``, a
    broadcast of a small and of a 1 MB object, ``smp.allgather``, the world
    and group barriers, and the exit-status relay at ``smp.shutdown``;
  - four ranks (tp 2 x rdp 2), ``_worker_subgroup``'s subgroup collectives:
    broadcast, allgather and barrier over proper subgroups, and a step at
    rdp beside cp (cp 2 x rdp 2) with its fp16 refusal.
In both worlds every rank answers the rank and group queries of ``smp`` for
several configurations, held against the JAX package's ``state.core`` for
the same configuration and device index (``_device_count_override``; the
JAX package's ``*_rank_to_rank`` answer for its default device, so the test
asks them with each device as the default). The instance queries differ by
design: the JAX package's instance is a process (one a host on a TPU pod),
the port's is a host (one process a device), and they are held on their own.

Also: the public names of the JAX package that the port lacks are exactly
``exec_cache`` and ``xray`` (ROADMAP item 10).
"""

import os

import pytest

import smdistributed_modelparallel_tpu as jax_smp
from chip_smoke import run_ranks

CONFIGS = {
    2: [
        {"ddp": True, "microbatches": 2},
        {"tensor_parallel_degree": 2, "ddp": True},
        {"pipeline_parallel_degree": 2, "microbatches": 2, "ddp": True},
    ],
    4: [
        {"tensor_parallel_degree": 2, "ddp": True},
        {"pipeline_parallel_degree": 2, "tensor_parallel_degree": 2, "microbatches": 2, "ddp": True},
        {"tensor_parallel_degree": 2, "ddp": True, "placement_strategy": "spread"},
        {"context_parallel_degree": 2, "ddp": True},
    ],
}
QUERIES = ("rank", "size", "pp_rank", "tp_rank", "rdp_rank", "dp_rank", "mp_rank", "cp_rank", "pp_size",
           "tp_size", "rdp_size", "dp_size", "mp_size", "cp_size", "num_microbatches", "get_pp_group",
           "get_tp_group", "get_dp_group", "get_rdp_group", "get_mp_group", "get_world_group",
           "get_pp_process_group", "get_tp_process_group", "get_dp_process_group", "get_rdp_process_group",
           "get_mp_process_group", "get_world_process_group")
TO_RANK = ("pp", "tp", "rdp", "dp", "mp")


def _answers(smp, cp_group):
    """Every query of ``smp`` for its current rank (the JAX package keeps
    its cp group on the core only)."""
    out = {q: getattr(smp, q)() for q in QUERIES}
    out["get_cp_group"] = cp_group()
    for axis in TO_RANK:
        n = getattr(smp, f"{axis}_size")()
        out[f"{axis}_rank_to_rank"] = [getattr(smp, f"{axis}_rank_to_rank")(i) for i in range(n)]
    out["mesh"] = dict(smp.get_mesh().shape)
    return out


def _jax_answers(cfg, n):
    """The JAX package's answers for each device index of ``n`` devices."""
    from smdistributed_modelparallel_tpu.backend.state import state

    jax_smp.reset()
    jax_smp.init({**cfg, "_device_count_override": n})
    core = state.core
    try:
        out = []
        for d in range(n):
            core._default_rank = lambda d=d: d  # the default device the queries answer for
            out.append(_answers(jax_smp, core.get_cp_group))
        return out
    finally:
        del core._default_rank
        jax_smp.reset()


def _queries(rank, world, smp):
    out = []
    for cfg in CONFIGS[world]:
        smp.init(cfg, device="cpu")
        out.append(_answers(smp, smp.get_cp_group))
    return out


def _two_rank_worker(rank, world):
    import hashlib

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend import core, native
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    out = {"queries": _queries(rank, world, smp)}
    smp.init({"ddp": True, "microbatches": 2}, device="cpu")
    out["bus_up"] = state.bus is not None and state.bus.world == world and state.bus.rank == rank
    out["lib"] = str(native.LIB_PATH)
    peer = 1 - rank
    smp.send({"from": rank}, dest=peer)
    out["p2p"] = smp.recv_from(peer)
    for i in range(5):
        smp.send(("seq", rank, i), dest=peer)
    out["ordered"] = [smp.recv_from(peer) for _ in range(5)]
    out["small"] = smp.broadcast({"root": "payload" * 100} if rank == 0 else None, src=0)
    big = os.urandom(1 << 20) if rank == 1 else None
    got = smp.broadcast(big, src=1)
    out["big_sha"] = hashlib.sha256(got).hexdigest()
    out["big_src_sha"] = hashlib.sha256(big).hexdigest() if big else None
    out["gathered"] = smp.allgather(f"proc{rank}")
    out["rdp_gathered"] = smp.allgather(rank * 10, group=smp.RDP_GROUP)
    for b in (smp.barrier, smp.dp_barrier, smp.rdp_barrier, smp.tp_barrier, smp.pp_barrier, smp.mp_barrier):
        b()
    out["instance"] = (smp.instance_id(), smp.is_in_same_instance(peer), smp.is_multi_node(), smp.local_size(),
                       smp.process_index(), smp.process_count())
    smp.shutdown()
    out["bus_closed"] = state.bus is None
    out["exit_report"] = core.last_exit_report
    return out


def _four_rank_worker(rank, world):
    import torch

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

    out = {"queries": _queries(rank, world, smp)}
    smp.init({"tensor_parallel_degree": 2, "ddp": True}, device="cpu")
    procs = state.comm.group_processes(smp.TP_GROUP)
    out["tp_procs"] = procs
    out["tp_bcast"] = smp.broadcast({"tp": rank}, src=0, group=smp.TP_GROUP)
    out["tp_gather"] = smp.allgather(rank, group=smp.TP_GROUP)
    out["rdp_bcast"] = smp.broadcast(("rdp", rank), src=1, group=smp.RDP_GROUP)
    out["rdp_gather"] = smp.allgather(rank, group=smp.RDP_GROUP)
    for _ in range(3):
        if smp.tp_rank() == 0:  # one tp subgroup member set at a time
            smp.barrier(group=smp.RDP_GROUP)
        smp.tp_barrier()
        smp.barrier()
    if smp.tp_rank() == 0:
        smp.send(rank, dest=1, group=smp.TP_GROUP)
    out["tp_p2p"] = smp.recv_from(0, group=smp.TP_GROUP) if smp.tp_rank() == 1 else None
    out["instance"] = (smp.instance_id(), [smp.is_in_same_instance(r) for r in range(world)], smp.is_multi_node(),
                       smp.local_size())

    out["rdp_beside_cp"] = {}
    for cfg in ({}, {"fp16": True}):
        smp.init({"context_parallel_degree": 2, "ddp": True, **cfg}, device="cpu")
        model = smp.DistributedModel(TransformerLM(vocab_size=64, max_len=16, d_model=32, n_layers=1, n_heads=4))

        @smp.step
        def train_step(model, ids):
            loss = model(ids, targets=ids).mean()
            model.backward(loss)
            return loss

        try:
            got = float(train_step(model, torch.zeros(2, 16, dtype=torch.long)).reduce_mean())
        except NotImplementedError as e:
            got = str(e)
        out["rdp_beside_cp"]["fp16" if cfg else "plain"] = got
    smp.shutdown()
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks(2, _two_rank_worker, timeout=300)


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks(4, _four_rank_worker, timeout=300)


def test_p2p_order_broadcast_allgather(two_ranks):
    for rank, r in enumerate(two_ranks):
        assert r["bus_up"]
        assert r["p2p"] == {"from": 1 - rank}
        assert r["ordered"] == [("seq", 1 - rank, i) for i in range(5)]
        assert r["small"] == {"root": "payload" * 100}
        assert r["big_sha"] == two_ranks[1]["big_src_sha"]
        assert r["gathered"] == ["proc0", "proc1"]
        assert r["rdp_gathered"] == [0, 10]


def test_bus_library_built_into_the_port(two_ranks):
    from smdistributed_modelparallel_tpu_torch.backend import native

    assert two_ranks[0]["lib"] == str(native.LIB_PATH)
    assert native.LIB_PATH.parent.name == "_build" and native.LIB_PATH.exists()


def test_exit_relay_and_bus_close(two_ranks):
    assert two_ranks[0]["exit_report"] == {"failed": [], "silent": []}
    assert all(r["bus_closed"] for r in two_ranks)


def test_instance_queries_one_host(two_ranks, four_ranks):
    """Every rank of these worlds is on this host: one instance."""
    assert [r["instance"] for r in two_ranks] == [(0, True, False, 2, 0, 2), (0, True, False, 2, 1, 2)]
    for r in four_ranks:
        assert r["instance"] == (0, [True] * 4, False, 4)


def test_subgroup_collectives_four_ranks(four_ranks):
    for rank, r in enumerate(four_ranks):
        tp = [rank - rank % 2, rank - rank % 2 + 1]  # tp2 x rdp2 in DPT order: tp pairs {0,1}, {2,3}
        rdp = [rank % 2, rank % 2 + 2]
        assert r["tp_procs"] == tp
        assert r["tp_bcast"] == {"tp": tp[0]}
        assert r["tp_gather"] == tp
        assert r["rdp_bcast"] == ("rdp", rdp[1])
        assert r["rdp_gather"] == rdp
        assert r["tp_p2p"] == (tp[0] if rank == tp[1] else None)


def test_rdp_beside_cp_refused(four_ranks):
    """rdp beside cp trains now (its parity: ``tests/test_torch_dp_cp_step.py``):
    every rank reports the same global loss. What stays refused there, fp16,
    names its ROADMAP item."""
    plain = [r["rdp_beside_cp"]["plain"] for r in four_ranks]
    assert all(isinstance(v, float) and v == plain[0] for v in plain), plain
    for r in four_ranks:
        got = r["rdp_beside_cp"]["fp16"]
        assert isinstance(got, str) and "ROADMAP Queue 1 item 6" in got, got


@pytest.mark.parametrize("world,index", [(w, i) for w in CONFIGS for i in range(len(CONFIGS[w]))])
def test_rank_queries_match_jax(two_ranks, four_ranks, world, index):
    per_rank = {2: two_ranks, 4: four_ranks}[world]
    want = _jax_answers(CONFIGS[world][index], world)
    for rank in range(world):
        assert per_rank[rank]["queries"][index] == want[rank], (rank, CONFIGS[world][index])


def _public_names(package):
    """The public names a package's ``__init__`` binds (imports, functions,
    classes, assignments): ``dir()`` would also list the submodules that
    other imports happened to load."""
    import ast
    import importlib.util

    tree = ast.parse(open(importlib.util.find_spec(package).origin).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_public_names_left_are_item_10():
    assert _public_names("smdistributed_modelparallel_tpu") - _public_names(
        "smdistributed_modelparallel_tpu_torch") == {"exec_cache", "xray"}
