"""The health sentinel's reduction: the CUDA kernel's wrapper and its plain
version.

The JAX package's sentinel (``utils/health.py``, ``HealthCollector.add_tree``
and ``add_stacked`` packed by ``pack()``) is a set of reductions XLA fuses
into the step program; no Pallas kernel is involved. The eager port computes
the same ``[K, 3]`` fp32 health word of a step in one launch of
``csrc/health_reduce.cu`` (``health_reduce``), in place of about six torch
launches a tensor.

An entry is ``(name, leaves, num_mb)``: ``num_mb`` None makes a tree entry
(``add_tree``), an int a stacked entry (``add_stacked``: each leaf leads with
the microbatch axis). A leaf is a tensor, or a list of tensors that count as
one leaf: for a tree entry the pieces of one JAX leaf (the port's per-layer
tensors of a stacked flax parameter), for a stacked entry its ``num_mb``
per-microbatch pieces. Row k of the word holds entry k's non-finite count
(each leaf counted exactly, converted to fp32 once and added in leaf order,
as ``jnp.sum(~fin).astype(f32)`` accumulates in the JAX collector), its
largest finite ``|x|`` (0 when there is none) and, for a stacked entry, the
first microbatch with a non-finite element (else -1).

``health_reduce`` runs ``reference_health_reduce`` for tensors on the CPU and
the kernel for CUDA tensors (fp32, bf16 or fp16, any layout: a tensor that is
not contiguous is made so), never falling back from one to the other;
``.launches`` counts the kernel launches. No single PyTorch call computes
this function.
"""

import ctypes

import numpy as np
import torch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_CHUNK = 16384  # csrc/health_reduce.cu's CHUNK
_TABLES = {}    # layout key -> (device table, S, K, L, total chunks, slots)
_MAX_TABLES = 16


def _is_cuda(t):
    """Whether the kernel would run on this tensor's device (one seam)."""
    return t.is_cuda


def _pieces(leaf):
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def _float_leaves(leaves):
    return [leaf for leaf in leaves if all(torch.is_floating_point(p) for p in _pieces(leaf))]


def reference_health_reduce(entries):
    """Plain PyTorch version of ``health_reduce``: ``isfinite``, ``sum``,
    ``where``, ``abs`` and ``amax`` per leaf, in the JAX collector's order,
    on the leaves' device and without a host sync."""
    rows = []
    for _name, leaves, num_mb in entries:
        leaves = _float_leaves(leaves)
        device = _pieces(leaves[0])[0].device
        bad = torch.zeros((), dtype=torch.float32, device=device)
        mx = torch.zeros((), dtype=torch.float32, device=device)
        per = None if num_mb is None else torch.zeros(num_mb, dtype=torch.float32, device=device)
        for leaf in leaves:
            pieces = _pieces(leaf)
            if per is None:
                count = sum((~torch.isfinite(p)).sum() for p in pieces)  # int64, exact
                bad = bad + count.to(torch.float32)
            else:
                if isinstance(leaf, (list, tuple)):
                    counts = torch.stack([(~torch.isfinite(p)).sum() for p in pieces])
                else:
                    counts = (~torch.isfinite(pieces[0].reshape(num_mb, -1))).sum(dim=1)
                per = per + counts.to(torch.float32)
            for p in pieces:
                if p.numel():
                    lf = p.float()
                    mx = torch.maximum(mx, torch.where(torch.isfinite(lf), lf.abs(), 0.0).max())
        if per is None:
            first = torch.full((), -1.0, device=device)
        else:
            bad = per.sum()
            first = torch.where(bad > 0, (per > 0).to(torch.int32).argmax().to(torch.float32), -1.0)
        rows.append(torch.stack([bad, mx, first]))
    return torch.stack(rows)


def _layout(entries):
    """The kernel's table for ``entries`` (numpy int64) and its sizes."""
    segs, leaf_slot, ebegin, enmb = [], [], [0], []
    slots = 0
    for k, (_name, leaves, num_mb) in enumerate(entries):
        nmb = 0 if num_mb is None else int(num_mb)
        for leaf in _float_leaves(leaves):
            pieces = _pieces(leaf)
            leaf_slot.append(slots)
            if nmb and len(pieces) == 1 and not isinstance(leaf, (list, tuple)):
                t = pieces[0]
                if t.numel() % nmb:
                    raise ValueError(f"health_reduce: a stacked leaf of {t.numel()} elements has no {nmb} equal rows")
                row = t.numel() // nmb
                rows = [(t.data_ptr() + mb * row * t.element_size(), row, t.dtype, slots + mb) for mb in range(nmb)]
            elif nmb:
                rows = [(p.data_ptr(), p.numel(), p.dtype, slots + mb) for mb, p in enumerate(pieces)]
            else:
                rows = [(p.data_ptr(), p.numel(), p.dtype, slots) for p in pieces]
            segs += [(ptr, n, _DTYPE_CODE[dt] | (k << 8), slot) for ptr, n, dt, slot in rows if n]
            slots += max(nmb, 1)
        ebegin.append(len(leaf_slot))
        enmb.append(nmb)
    chunks = np.array([-(-n // _CHUNK) for _, n, _, _ in segs], dtype=np.int64)
    prefix = np.concatenate([[0], np.cumsum(chunks)]).astype(np.int64)
    table = np.concatenate([
        np.array(segs, dtype=np.int64).reshape(-1), prefix,
        np.array(leaf_slot, dtype=np.int64), np.array(ebegin, dtype=np.int64), np.array(enmb, dtype=np.int64),
    ]).astype(np.int64)
    return table, len(segs), len(entries), len(leaf_slot), int(prefix[-1]), slots


def _contiguous(entries):
    """``entries`` with every piece contiguous, and the layout key."""
    out, key = [], []
    for name, leaves, num_mb in entries:
        fixed = []
        for leaf in _float_leaves(leaves):
            if isinstance(leaf, (list, tuple)):
                fixed.append([p.contiguous() for p in leaf])
            else:
                fixed.append(leaf.contiguous())
            key.append((num_mb, isinstance(leaf, (list, tuple)),
                        tuple((p.data_ptr(), p.numel(), p.dtype) for p in _pieces(fixed[-1]))))
        out.append((name, fixed, num_mb))
        key.append(None)
    return out, tuple(key)


def health_reduce(entries):
    """The ``[K, 3]`` fp32 health word of ``entries`` (see the module
    docstring) on their device: the plain version on the CPU,
    ``csrc/health_reduce.cu`` on a CUDA device."""
    entries = [e for e in entries if _float_leaves(e[1])]
    if not entries:
        raise ValueError("health_reduce: no entry has a floating-point leaf")
    first = _pieces(_float_leaves(entries[0][1])[0])[0]
    pieces = [p for _, leaves, _ in entries for leaf in _float_leaves(leaves) for p in _pieces(leaf)]
    if first.device.type == "cpu":
        if any(p.device.type != "cpu" for p in pieces):
            raise ValueError("health_reduce: the leaves lie on more than one device")
        return reference_health_reduce(entries)
    if not _is_cuda(first):
        raise ValueError(f"health_reduce: device {first.device} is neither the CPU nor a CUDA device")
    for p in pieces:
        if p.device != first.device:
            raise ValueError(f"health_reduce: leaves on {first.device} and {p.device}")
        if p.dtype not in _DTYPE_CODE:
            raise TypeError(f"health_reduce: the kernel reads fp32, fp16 and bf16 tensors, not {p.dtype}")
    entries, key = _contiguous(entries)
    device = first.device
    hit = _TABLES.get((device, key))
    if hit is None:
        table, S, K, L, total, slots = _layout(entries)
        dev_table = torch.from_numpy(table).pin_memory().to(device, non_blocking=True)
        if len(_TABLES) >= _MAX_TABLES:
            _TABLES.pop(next(iter(_TABLES)))
        hit = _TABLES[(device, key)] = (dev_table, S, K, L, total, slots)
    dev_table, S, K, L, total, slots = hit
    word = torch.empty((K, 3), dtype=torch.float32, device=device)
    scratch = torch.empty(slots * 8 + K * 4 + 4, dtype=torch.uint8, device=device)
    lib = _kernel()
    with torch.cuda.device(device):
        err = lib.smp_health_reduce(dev_table.data_ptr(), S, K, L, total, slots, scratch.data_ptr(),
                                    word.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smp_health_reduce launch failed: {lib.smp_cuda_error_string(err).decode()}")
    health_reduce.launches += 1
    return word


health_reduce.launches = 0

_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("health_reduce")
        c_int, c_ptr, c_i64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.smp_health_reduce.argtypes = [c_ptr, c_int, c_int, c_int, c_i64, c_i64, c_ptr, c_ptr, c_ptr]
        lib.smp_health_reduce.restype = c_int
        lib.smp_health_reduce_chunk.argtypes = []
        lib.smp_health_reduce_chunk.restype = c_i64
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        if lib.smp_health_reduce_chunk() != _CHUNK:
            raise RuntimeError("csrc/health_reduce.cu's CHUNK differs from ops/health_reduce.py's _CHUNK")
        _LIB = lib
    return _LIB
