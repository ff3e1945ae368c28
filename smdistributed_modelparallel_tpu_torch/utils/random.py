"""Random keys: the JAX package's key stream, derived on the host.

Counterpart of ``smdistributed_modelparallel_tpu/utils/random.py``
(``RngManager``, ``_stream_id``) together with the parts of ``jax.random``
that the package draws from, so that the same seed gives the same keys, the
same dropout masks and the same sampled tokens in both packages:

- a key is the two uint32 words of ``jax.random.key_data`` (a numpy uint32
  array of shape (2,); ``split`` gives (n, 2)). ``key(seed)`` is
  ``jax.random.key(seed)``'s threefry seed as JAX computes it with 64-bit
  types off: the seed is taken modulo 2**32 (so -1 is 0xFFFFFFFF) and the
  high word is 0;
- ``threefry2x32`` is the Threefry-2x32 hash (20 rounds) of the JAX
  package's ``jax_threefry_partitionable`` layout: ``split(key, n)[i]``,
  ``fold_in(key, i)`` and the bits of element ``i`` of an array are all the
  hash of the counter ``(i >> 32, i & 0xFFFFFFFF)``; an element's bits
  (``bits32``) XOR the two output words;
- ``fold_in_static`` is flax's ``_fold_in_static``: one ``fold_in`` of the
  first 4 bytes (big-endian) of the SHA-1 of the path parts and the scope's
  counter, with no separator (flax 0.12's default).
  ``DistributedModel.make_rng`` uses it to give a module its flax scope key.

Keys are small, so they are derived on the host (Python integers, exact);
no derivation launches anything on a device or waits for one. The bulk
draws over a key (``bits``, ``uniform``, ``bernoulli``, ``gumbel``,
``categorical``: a dropout mask, a Gumbel draw over [B, V]) live beside
their kernel in ``ops/dropout.py``.
"""

import hashlib
import zlib

import numpy as np

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` under
    ``key``: ``(y0, y1)``. The words may be Python integers (the host's
    keys) or int64 tensors holding values below 2**32 (the plain version of
    the bits kernel): every sum and shift is masked to 32 bits, so none of
    them overflows."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & MASK32)) & MASK32
    return x0, x1


def as_key(key):
    """``key`` as a numpy uint32 array of shape (2,); raises for anything
    else (a ``torch.Generator`` is not a key)."""
    arr = np.asarray(key)
    if arr.shape != (2,) or arr.dtype.kind not in "ui" or (arr.dtype.kind == "i" and (arr < 0).any()):
        raise TypeError(f"a key is two uint32 words (utils.random.key(seed)), got {key!r}")
    return arr.astype(np.uint32)


def key(seed):
    """``jax.random.key(seed)``'s data: ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -(2**63) <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    return np.array([0, seed & MASK32], dtype=np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for an integer ``data`` (taken
    modulo 2**32, as JAX converts it to uint32)."""
    return np.array(threefry2x32(as_key(key), 0, int(data) & MASK32), dtype=np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)``: a [num, 2] uint32 array (element i is
    ``fold_in(key, i)``; a handful of Python-integer hashes cost less than
    numpy's per-call overhead on arrays this small)."""
    key = as_key(key)
    return np.array([threefry2x32(key, i >> 32, i & MASK32) for i in range(num)], dtype=np.uint32).reshape(num, 2)


def bits32(key, index=0):
    """The uint32 bits of element ``index`` of ``jax.random.bits(key,
    shape)`` (for any shape), as a Python integer; ``bits32(key)`` is
    ``bits(key, ())``."""
    y0, y1 = threefry2x32(as_key(key), index >> 32, index & MASK32)
    return y0 ^ y1


def to_int32(u32):
    """A uint32 value's bits as an int32 (JAX's ``bitcast_convert_type``)."""
    return u32 - (1 << 32) if u32 >= 1 << 31 else u32


def fold_in_static(key, data):
    """flax's ``_fold_in_static(key, data)``: ``key`` unchanged for empty
    ``data``, else one ``fold_in`` of the first 4 bytes of the SHA-1 of the
    parts (strings as UTF-8, integers big-endian in their fewest bytes)."""
    if not data:
        return as_key(key)
    return fold_in(key, _static_hash(tuple(data)))


_STATIC_HASHES = {}


def _static_hash(data):
    h = _STATIC_HASHES.get(data)
    if h is None:
        m = hashlib.sha1()
        for x in data:
            if isinstance(x, str):
                m.update(x.encode("utf-8"))
            elif isinstance(x, int):
                m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
            else:
                raise ValueError(f"Expected int or string, got: {x}")
        h = _STATIC_HASHES[data] = int.from_bytes(m.digest()[:4], byteorder="big")
    return h


def _stream_id(stream):
    # Stable across processes (Python's hash() is salted per process).
    return zlib.crc32(str(stream).encode())


class RngManager:
    """Named key streams from one seed (``tensor_parallel_seed``): each key
    is ``fold_in(fold_in(key(seed), crc32(stream)), count)``, ``count`` the
    stream's number of earlier draws. The same call history gives the same
    keys in every process, and in both packages."""

    def __init__(self, tensor_parallel_seed=0):
        self.base_seed = int(tensor_parallel_seed)
        self._root = key(self.base_seed)
        self._counters = {}

    def next_key(self, stream="default"):
        count = self._counters.get(stream, 0)
        self._counters[stream] = count + 1
        return fold_in(fold_in(self._root, _stream_id(stream)), count)

    def per_rank_key(self, stream, axis_name):
        """``next_key(stream)`` folded with this rank's coordinate along the
        mesh axis ``axis_name``: a key that differs along that axis."""
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        index = 0 if state.topology is None else state.topology.coords(state.rank)[axis_name]
        return fold_in(self.next_key(stream), index)

    def init_rngs(self, streams=("params", "dropout")):
        return {s: self.next_key(s) for s in streams}

    def reset(self):
        self._counters.clear()
