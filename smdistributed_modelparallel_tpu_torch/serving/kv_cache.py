"""Host-side block allocator for the paged KV cache (``smp.serving``).

A copy of ``smdistributed_modelparallel_tpu/serving/kv_cache.py`` (the
module imports no JAX there either). The device side
(``nn/utils.PagedKVCache``) is a pool of ``num_blocks`` fixed-size token
blocks a layer; what makes it *paged* lives here: a free list, the ordered
block list of each sequence, and the block tables the serving engine's two
programs take. The allocator is plain Python, run in the engine's host loop
every tick, and strict: double frees, foreign blocks and growth past a
reservation raise instead of corrupting the pool.

Block 0 is RESERVED as the trash block: unused block-table entries point at
it, so writes from inactive decode slots and padded prefill tails land there
instead of in live sequences (see ``PagedKVCache``).

Admission safety: ``reserve`` books a sequence's worst-case block count
(prompt + max_new_tokens) without allocating; ``ensure`` then allocates
lazily as the sequence grows. A request is admitted only when its worst case
fits in the free blocks less the blocks already promised, so the pool cannot
run out mid-stream, while a finished sequence releases every block (and its
unused reservation) at once.
"""

import os

from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

BLOCK_TOKENS_ENV = "SMP_KV_BLOCK_TOKENS"
PREFILL_CHUNK_ENV = "SMP_PREFILL_CHUNK"
SLOTS_ENV = "SMP_SERVE_SLOTS"

#: Reserved trash block (see module docstring).
TRASH_BLOCK = 0


def _env_int(name, default, floor=1):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        logger.warning("ignoring non-integer %s=%r; using %d.",
                       name, raw, default)
        return default
    if val < floor:
        logger.warning("%s=%d below the floor %d; using %d.",
                       name, val, floor, floor)
        return floor
    return val


def block_tokens(default=16):
    """Tokens per KV-cache block (``SMP_KV_BLOCK_TOKENS``, default 16)."""
    return _env_int(BLOCK_TOKENS_ENV, default)


def prefill_chunk_tokens(default=32):
    """Prompt tokens per prefill slice (``SMP_PREFILL_CHUNK``, default
    32): one slice runs per engine tick, interleaved with decode steps,
    so a long prompt never stalls in-flight streams."""
    return _env_int(PREFILL_CHUNK_ENV, default)


def serve_slots(default=4):
    """Concurrent decode slots of the engine (``SMP_SERVE_SLOTS``)."""
    return _env_int(SLOTS_ENV, default)


class BlockAllocator:
    """Free list + per-sequence block tables over a fixed pool."""

    def __init__(self, num_blocks, block_tokens, max_blocks_per_seq):
        if num_blocks < 2:
            raise ValueError(
                "the pool needs at least 2 blocks (block 0 is the "
                "reserved trash block)."
            )
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.max_blocks_per_seq = max_blocks_per_seq
        # LIFO free list: recently freed blocks are re-used first (their
        # pool slots are the likeliest still in cache on the host side,
        # and determinism helps the tests).
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._owned = {}      # sid -> ordered block ids
        self._reserved = {}   # sid -> worst-case block count

    # -- bookkeeping ----------------------------------------------------

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return sum(len(b) for b in self._owned.values())

    @property
    def reserved_unallocated(self):
        """Blocks promised to admitted sequences but not yet allocated."""
        return sum(
            max(r - len(self._owned.get(sid, ())), 0)
            for sid, r in self._reserved.items()
        )

    def blocks_for_tokens(self, tokens):
        return -(-int(tokens) // self.block_tokens)  # ceil div

    def can_reserve(self, tokens):
        """True when a sequence of worst-case ``tokens`` length can be
        admitted without any possibility of mid-stream exhaustion."""
        need = self.blocks_for_tokens(tokens)
        if need > self.max_blocks_per_seq:
            return False
        return need <= self.free_blocks - self.reserved_unallocated

    # -- lifecycle ------------------------------------------------------

    def reserve(self, sid, tokens):
        if sid in self._reserved or sid in self._owned:
            raise ValueError(f"sequence {sid!r} already admitted")
        if not self.can_reserve(tokens):
            raise ValueError(
                f"pool cannot admit {sid!r} ({tokens} tokens): "
                f"{self.free_blocks} free, "
                f"{self.reserved_unallocated} already promised"
            )
        self._reserved[sid] = self.blocks_for_tokens(tokens)
        self._owned.setdefault(sid, [])

    def ensure(self, sid, tokens):
        """Allocate blocks so ``sid`` can hold ``tokens`` tokens."""
        if sid not in self._reserved:
            raise ValueError(f"sequence {sid!r} was never reserved")
        need = self.blocks_for_tokens(tokens)
        if need > self._reserved[sid]:
            raise ValueError(
                f"sequence {sid!r} grew past its reservation "
                f"({need} > {self._reserved[sid]} blocks)"
            )
        owned = self._owned[sid]
        while len(owned) < need:
            owned.append(self._free.pop())

    def release(self, sid):
        """Return every block (and the unused reservation) to the pool."""
        blocks = self._owned.pop(sid, [])
        self._reserved.pop(sid, None)
        self._free.extend(reversed(blocks))
        return len(blocks)

    def table(self, sid):
        """The sequence's block table as a fixed-width python list
        (length ``max_blocks_per_seq``; unused entries = trash block)."""
        row = [TRASH_BLOCK] * self.max_blocks_per_seq
        for j, b in enumerate(self._owned.get(sid, ())):
            row[j] = b
        return row

    def check(self):
        """Invariant audit (used by the fuzz test): every block is in
        exactly one place — the free list or one sequence's table — and
        the trash block is in neither."""
        seen = {}
        for b in self._free:
            seen[b] = seen.get(b, 0) + 1
        for sid, blocks in self._owned.items():
            for b in blocks:
                seen[b] = seen.get(b, 0) + 1
        problems = []
        if TRASH_BLOCK in seen:
            problems.append("trash block handed out")
        for b, n in seen.items():
            if n > 1:
                problems.append(f"block {b} assigned {n} times")
        missing = set(range(1, self.num_blocks)) - set(seen)
        if missing:
            problems.append(f"blocks leaked: {sorted(missing)}")
        return problems
