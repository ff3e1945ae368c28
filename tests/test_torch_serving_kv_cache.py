"""The port's paged-KV block allocator (``serving/kv_cache.py``) against the
JAX package's: the reference's unit cases, and one seeded fuzz that drives
both allocators through the same operations and compares them after each."""

import random

import pytest

from smdistributed_modelparallel_tpu.serving.kv_cache import BlockAllocator as JaxBlockAllocator
from smdistributed_modelparallel_tpu_torch.serving import kv_cache
from smdistributed_modelparallel_tpu_torch.serving.kv_cache import TRASH_BLOCK, BlockAllocator


def test_reserve_then_lazy_growth():
    a = BlockAllocator(num_blocks=10, block_tokens=4, max_blocks_per_seq=8)
    assert a.free_blocks == 9  # block 0 reserved (trash)
    a.reserve("s0", 13)        # worst case 4 blocks
    assert a.used_blocks == 0 and a.reserved_unallocated == 4
    a.ensure("s0", 5)          # 2 blocks materialize
    assert a.used_blocks == 2 and a.reserved_unallocated == 2
    table = a.table("s0")
    assert len(table) == 8 and table[2:] == [TRASH_BLOCK] * 6
    assert TRASH_BLOCK not in table[:2]
    a.ensure("s0", 13)
    assert a.used_blocks == 4
    assert a.release("s0") == 4
    assert a.free_blocks == 9 and a.reserved_unallocated == 0


def test_admission_counts_promises():
    a = BlockAllocator(num_blocks=9, block_tokens=4, max_blocks_per_seq=8)
    a.reserve("s0", 16)        # promises 4 of the 8 free
    assert a.can_reserve(16)   # 4 left
    a.reserve("s1", 16)
    assert not a.can_reserve(1)  # everything promised
    a.release("s0")
    assert a.can_reserve(16)


def test_errors():
    a = BlockAllocator(num_blocks=6, block_tokens=4, max_blocks_per_seq=4)
    a.reserve("s0", 8)
    with pytest.raises(ValueError, match="already admitted"):
        a.reserve("s0", 4)
    with pytest.raises(ValueError, match="never reserved"):
        a.ensure("ghost", 4)
    with pytest.raises(ValueError, match="past its reservation"):
        a.ensure("s0", 12)
    with pytest.raises(ValueError, match="cannot admit"):
        a.reserve("too_long", 100)  # exceeds max_blocks_per_seq
    with pytest.raises(ValueError, match="at least 2 blocks"):
        BlockAllocator(num_blocks=1, block_tokens=4, max_blocks_per_seq=4)


def test_fuzz_never_double_assigns_or_leaks():
    """Randomized admit/grow/finish against the invariant auditor: every
    block in exactly one place at every step."""
    rng = random.Random(1234)
    a = BlockAllocator(num_blocks=24, block_tokens=4, max_blocks_per_seq=10)
    live = {}
    sid = 0
    for step in range(2000):
        op = rng.random()
        if op < 0.4 and live:
            s = rng.choice(list(live))
            cap, cur = live[s]
            grown = min(cur + rng.randint(1, 6), cap)
            a.ensure(s, grown)
            live[s] = (cap, grown)
        elif op < 0.7:
            tokens = rng.randint(1, 40)
            if a.blocks_for_tokens(tokens) <= a.max_blocks_per_seq and a.can_reserve(tokens):
                name = f"s{sid}"
                sid += 1
                a.reserve(name, tokens)
                live[name] = (tokens, 0)
        elif live:
            s = rng.choice(list(live))
            a.release(s)
            del live[s]
        assert a.check() == [], f"invariants broken at step {step}"
    for s in list(live):
        a.release(s)
    assert a.check() == []
    assert a.free_blocks == 23 and a.used_blocks == 0


def _state(a, sids):
    return (a.free_blocks, a.used_blocks, a.reserved_unallocated, a.check(), {s: a.table(s) for s in sids})


@pytest.mark.parametrize("seed", [0, 7])
def test_fuzz_matches_jax_allocator(seed):
    """The same seeded operations (reserve, can_reserve, ensure, release,
    and the errors of each) on both allocators: equal tables, free counts,
    promises and audits after every operation."""
    rng = random.Random(seed)
    port = BlockAllocator(num_blocks=20, block_tokens=4, max_blocks_per_seq=8)
    ref = JaxBlockAllocator(num_blocks=20, block_tokens=4, max_blocks_per_seq=8)
    sids = [f"s{i}" for i in range(12)]
    for step in range(1500):
        op, sid, tokens = rng.choice(("reserve", "ensure", "release", "can_reserve")), rng.choice(sids), \
            rng.randint(1, 40)
        outs = []
        for a in (port, ref):
            try:
                outs.append(("ok", getattr(a, op)(*((sid,) if op == "release" else (tokens,) if op == "can_reserve"
                                                     else (sid, tokens)))))
            except ValueError as e:
                outs.append(("error", str(e)))
        assert outs[0] == outs[1], (step, op, sid, tokens)
        assert _state(port, sids) == _state(ref, sids), (step, op, sid, tokens)
    assert port.check() == [] and port.blocks_for_tokens(13) == ref.blocks_for_tokens(13)


def test_env_geometry(monkeypatch):
    """``block_tokens``, ``prefill_chunk_tokens`` and ``serve_slots`` read
    their variables as the JAX package does: defaults, overrides, floors."""
    for var in (kv_cache.BLOCK_TOKENS_ENV, kv_cache.PREFILL_CHUNK_ENV, kv_cache.SLOTS_ENV):
        monkeypatch.delenv(var, raising=False)
    assert (kv_cache.block_tokens(), kv_cache.prefill_chunk_tokens(), kv_cache.serve_slots()) == (16, 32, 4)
    monkeypatch.setenv(kv_cache.BLOCK_TOKENS_ENV, "8")
    monkeypatch.setenv(kv_cache.PREFILL_CHUNK_ENV, "0")      # below the floor of 1
    monkeypatch.setenv(kv_cache.SLOTS_ENV, "many")           # not an integer: the default
    assert (kv_cache.block_tokens(), kv_cache.prefill_chunk_tokens(), kv_cache.serve_slots()) == (8, 1, 4)
