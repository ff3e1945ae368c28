"""The sentinel's reduction (``ops/health_reduce.py``) against the JAX
package's ``HealthCollector``.

- The plain version gives the JAX package's health word for the same trees:
  ``add_tree`` and ``add_stacked`` packed by ``pack()``, on random trees in
  fp32 and bf16 with NaN, +inf and -inf injected, and stacked trees whose
  first bad microbatch is 0, 1 or none. Exact (``assert_array_equal``): the
  counts are integers and the abs-max is a max of the same fp32 values.
- The kernel's table: ``_layout`` run on CPU tensors and walked by a Python
  emulation of ``csrc/health_reduce.cu`` (chunks found by the prefix sum,
  counts a slot, abs-max an entry, the last-block epilogue) reading the
  tensors' memory through their addresses gives the plain version's word;
  with stacked leaves as [num_mb, ...] tensors, as per-microbatch pieces,
  leaves grouped into one JAX leaf, views that are not contiguous, empty
  and one-element tensors, and tensors longer than one chunk.
- The wrapper's checks: the CPU runs the plain version; a device that is
  neither, mixed devices and dtypes the kernel does not read raise.
The kernel itself on the card: ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``'s phase B.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from smdistributed_modelparallel_tpu.utils.health import HealthCollector as JaxCollector
from smdistributed_modelparallel_tpu_torch.ops import health_reduce as hr
from smdistributed_modelparallel_tpu_torch.utils.health import HealthCollector, Leaf

_NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}


def _poisoned(rng, shape, dtype, n_bad):
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.1, 30.0)
    flat = x.reshape(-1)
    for idx, v in zip(rng.choice(flat.size, size=min(n_bad, flat.size), replace=False),
                      rng.choice([np.nan, np.inf, -np.inf], size=n_bad)):
        flat[idx] = v
    return x.astype(_NP[dtype])


def _torch(a, dtype):
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def _tree(rng, dtype, shapes, n_bad):
    return {f"leaf{i:02d}": _poisoned(rng, s, dtype, n_bad if i % 2 else 0) for i, s in enumerate(shapes)}


def _jax_word(entries):
    """entries: [(name, {key: numpy}, num_mb or None)] through the JAX
    collector."""
    hc = JaxCollector("cheap")
    for name, tree, num_mb in entries:
        jtree = {k: jnp.asarray(v) for k, v in tree.items()}
        if num_mb is None:
            hc.add_tree(name, jtree)
        else:
            hc.add_stacked(name, jtree, num_mb)
    word, names = hc.pack()
    return np.asarray(jax.device_get(word)), names


def _port_word(entries, dtype):
    hc = HealthCollector("cheap")
    for name, tree, num_mb in entries:
        ttree = {k: _torch(v, dtype) for k, v in tree.items()}
        if num_mb is None:
            hc.add_tree(name, ttree)
        else:
            hc.add_stacked(name, ttree, num_mb)
    word, names = hc.pack()
    return word.numpy(), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_entries_match_jax(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = [(7,), (3, 5), (1,), (4, 4, 2), (33,), (2, 65)]
    entries = [("grads", _tree(rng, dtype, shapes, 1 + seed), None),
               ("params", _tree(rng, dtype, shapes[:3], 0), None),
               ("all_bad", {"a": np.full((5,), np.nan, _NP[dtype])}, None)]
    want, names = _jax_word(entries)
    got, got_names = _port_word(entries, dtype)
    assert got_names == names
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > 0 and got[1, 0] == 0 and got[2, 1] == 0  # a finite max of none is 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bad_mb", [0, 1, None], ids=["mb0", "mb1", "clean"])
def test_stacked_entries_match_jax(dtype, bad_mb):
    rng = np.random.default_rng(7)
    num_mb = 4
    tree = {"loss": rng.standard_normal((num_mb,)).astype(_NP[dtype]),
            "logits": rng.standard_normal((num_mb, 2, 3, 5)).astype(_NP[dtype])}
    if bad_mb is not None:
        tree["logits"][bad_mb, 1, 2, 4] = np.inf
        tree["logits"][3, 0, 0, 0] = np.nan  # a later microbatch too: the FIRST is reported
        tree["loss"][bad_mb] = -np.inf
    entries = [("outputs", tree, num_mb), ("loss", {"l": tree["loss"]}, num_mb)]
    want, names = _jax_word(entries)
    got, got_names = _port_word(entries, dtype)
    assert got_names == names
    np.testing.assert_array_equal(got, want)
    assert got[0, 2] == (-1 if bad_mb is None else bad_mb)


# ----------------------------------------------------------------------
# The kernel's table, walked by an emulation of csrc/health_reduce.cu
# ----------------------------------------------------------------------


_CT = {0: (ctypes.c_float, np.float32), 1: (ctypes.c_uint16, np.float16), 2: (ctypes.c_uint16, None)}


def _read(ptr, n, dtype):
    ct, npdt = _CT[dtype]
    raw = np.ctypeslib.as_array((ct * n).from_address(ptr)).copy()
    if dtype == 0:
        return raw.astype(np.float32)
    if dtype == 1:
        return raw.view(np.float16).astype(np.float32)
    return (raw.astype(np.uint32) << 16).view(np.float32)  # bf16 bits -> fp32


def _emulate(entries):
    """What the kernel computes from ``_layout``'s table: per chunk, the
    segment by the prefix sum; counts into the slot, abs-max into the
    entry; then the epilogue over the leaves."""
    entries, _key = hr._contiguous([e for e in entries if hr._float_leaves(e[1])])
    table, S, K, L, total, slots = hr._layout(entries)
    segs = table[:4 * S].reshape(S, 4)
    prefix = table[4 * S:5 * S + 1]
    leaf = table[5 * S + 1:5 * S + 1 + L]
    ebegin = table[5 * S + 1 + L:5 * S + 2 + L + K]
    enmb = table[5 * S + 2 + L + K:]
    assert len(enmb) == K and prefix[-1] == total
    counts = np.zeros(slots, np.uint64)
    absmax = np.zeros(K, np.float32)
    for c in range(total):
        s = int(np.searchsorted(prefix, c, side="right") - 1)
        ptr, n, code, slot = (int(v) for v in segs[s])
        dtype, entry = code & 0xFF, code >> 8
        start = (c - int(prefix[s])) * hr._CHUNK
        vals = _read(ptr + start * (4 if dtype == 0 else 2), min(hr._CHUNK, n - start), dtype)
        fin = np.isfinite(vals)
        counts[slot] += np.uint64((~fin).sum())
        if fin.any():
            absmax[entry] = max(absmax[entry], np.abs(vals[fin]).max())
    word = np.zeros((K, 3), np.float32)
    for k in range(K):
        bad, first = np.float32(0), np.float32(-1)
        nmb = int(enmb[k])
        if nmb == 0:
            for l in range(ebegin[k], ebegin[k + 1]):
                bad = np.float32(bad + np.float32(counts[leaf[l]]))
        else:
            for mb in range(nmb):
                per = np.float32(0)
                for l in range(ebegin[k], ebegin[k + 1]):
                    per = np.float32(per + np.float32(counts[leaf[l] + mb]))
                bad = np.float32(bad + per)
                if first < 0 and per > 0:
                    first = np.float32(mb)
            if not bad > 0:
                first = np.float32(-1)
        word[k] = (bad, absmax[k], first)
    return word


def _mixed_entries():
    g = torch.Generator().manual_seed(3)

    def t(*shape, dtype=torch.float32, bad=()):
        x = (torch.randn(*shape, generator=g) * 5).to(dtype)
        flat = x.view(-1)
        for i, v in bad:
            flat[i] = v
        return x

    big = t(hr._CHUNK * 2 + 77, bad=((0, float("nan")), (hr._CHUNK, float("inf")), (hr._CHUNK * 2 + 76, float("-inf"))))
    view = t(6, 10, dtype=torch.bfloat16, bad=((13, float("nan")),))[:, 1:7]  # not contiguous
    layers = [t(4, 8, bad=((5, float("nan")),) if i == 1 else ()) for i in range(3)]
    per_mb = [t(5, dtype=torch.float16, bad=((2, float("inf")),) if mb == 2 else ()) for mb in range(4)]
    stacked = t(4, 3, 7, bad=((3 * 7 * 1 + 4, float("nan")), (3 * 7 * 3, float("nan"))))
    return [
        ("params", [big, view, Leaf(layers), torch.ones(1), torch.empty(0), torch.arange(3)], None),
        ("loss", [Leaf(per_mb)], 4),
        ("outputs", [stacked, t(4, 1)], 4),
        ("ints", [torch.arange(5)], None),  # no float leaf: dropped, as the JAX collector drops it
    ]


def test_kernel_layout_emulation_matches_plain_version():
    hc = HealthCollector("cheap")
    for name, leaves, num_mb in _mixed_entries():
        (hc.add_tree(name, leaves) if num_mb is None else hc.add_stacked(name, leaves, num_mb))
    want = hr.reference_health_reduce(hc.entries)
    got = _emulate(hc.entries)
    np.testing.assert_array_equal(got, want.numpy())
    assert [n for n, _, _ in hc.entries] == ["params", "loss", "outputs"]
    assert want[0, 0] == 5 and want[1].tolist() == [1.0, want[1, 1].item(), 2.0] and want[2, 0] == 2 and want[2, 2] == 1


def test_grouped_leaf_counts_once_per_jax_leaf():
    """A JAX leaf's pieces share one count slot: converted to fp32 once."""
    x = torch.full((5,), float("nan"))
    grouped = hr.reference_health_reduce([("g", [[x, x.clone()]], None)])
    apart = hr.reference_health_reduce([("g", [x, x.clone()], None)])
    assert grouped[0, 0] == apart[0, 0] == 10
    table, S, K, L, total, slots = hr._layout(hr._contiguous([("g", [[x, x.clone()]], None)])[0])
    assert (S, K, L, slots) == (2, 1, 1, 1)


def test_wrapper_checks():
    x = torch.randn(4)
    np.testing.assert_array_equal(hr.health_reduce([("a", [x], None)]).numpy(),
                                  hr.reference_health_reduce([("a", [x], None)]).numpy())
    with pytest.raises(ValueError, match="no entry"):
        hr.health_reduce([("a", [torch.arange(3)], None)])
    with pytest.raises(ValueError, match="neither the CPU nor a CUDA device"):
        hr.health_reduce([("a", [torch.empty(3, device="meta")], None)])
    with pytest.raises(ValueError, match="more than one device"):
        hr.health_reduce([("a", [x, torch.empty(3, device="meta")], None)])
    with pytest.raises(ValueError, match="equal rows"):
        hr._layout([("a", [torch.randn(5)], 2)])
