"""Sharded checkpoint IO of the PyTorch port, in the JAX package's format.

Counterpart of ``smdistributed_modelparallel_tpu/shard_io.py``. A checkpoint
component (model or optimizer) is one ``{name}_shards_p{process}.npz`` per
process; each entry is keyed ``"{path}|{bounds}"``, where ``path`` is the
leaf's '/'-joined key (``module_manager.path_key``) and ``bounds`` the JSON
``[[start, stop], ...]`` of the global region the piece holds (``"[]"`` for a
scalar), or ``"{path}|full"`` for a whole leaf. Every global element is
stored once across the files.

At tp = 1 the port holds every leaf whole on its device, so a rank's payload
is each leaf as one piece with full bounds, written by the rank that holds
replica 0 (the rank at coordinate 0 of every axis that replicates the
parameters: rdp, cp, ep); the other ranks write empty files. At tp > 1 each
tp rank of replica 0 writes its own region of every tp-sharded leaf (the
``tp_pieces`` bounds, ``DistributedModel.tp_pieces``) and tp rank 0 the
replicated leaves whole. Reading assembles a leaf from the pieces that cover
it, whatever layout wrote them (the JAX package's tp 2 or pp 2 checkpoints
split their leaves too).
"""

import glob
import json
import os

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.convert import is_bf16, numpy_dtype, to_numpy, to_torch
from smdistributed_modelparallel_tpu_torch.module_manager import path_key, tree_flatten_with_path
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPRuntimeError

_SEP = "|"
# Axes over which the port's parameters and optimizer state are replicated.
_REPLICA_AXES = ("rdp", "ep", "cp")


def _full_bounds(shape):
    return json.dumps([[0, int(d)] for d in shape])


def _holds_replica0():
    """True when this rank holds replica 0 of every leaf."""
    if state.topology is None:
        return True
    coords = state.topology.coords(state.rank)
    return all(coords.get(ax, 0) == 0 for ax in _REPLICA_AXES)


def shard_payload(tree, dedupe_global=True, tp_pieces=None):
    """This rank's pieces of ``tree`` (a flat ``{key: array}`` dict, or a
    tree of dicts, tuples and namedtuples whose paths ``path_key`` joins)
    as a flat ``{"key|bounds": np.ndarray}`` dict: the ``local_state_dict``
    representation and the npz layout.

    ``dedupe_global=True`` (checkpoint files): only the rank holding
    replica 0 contributes, so each element is stored once across ranks.
    ``dedupe_global=False`` (``local_state_dict``): every rank's payload is
    complete. ``tp_pieces`` ({key: [[start, stop], ...]}, at tp > 1): the
    regions of the tp-sharded leaves this tp rank writes; the other leaves
    come from tp rank 0 only. Tensors are copied to the host, so a later
    in-place update cannot reach the payload; numpy arrays are taken as they
    are."""
    if dedupe_global and not _holds_replica0():
        return {}
    tp_index = state.topology.coords(state.rank).get("tp", 0) if tp_pieces and state.topology is not None else 0
    payload = {}
    for path, leaf in tree_flatten_with_path(tree):
        key = path_key(path)
        bounds = (tp_pieces or {}).get(key)
        if bounds is None and tp_index:
            continue
        arr = to_numpy(leaf, copy=isinstance(leaf, torch.Tensor) and bounds is None)
        if bounds is not None:
            arr = np.ascontiguousarray(arr[tuple(slice(a, b) for a, b in bounds)])
            payload[f"{key}{_SEP}{json.dumps(bounds)}"] = arr
        else:
            payload[f"{key}{_SEP}{_full_bounds(arr.shape)}"] = arr
    return payload


def is_shard_payload(flat_dict):
    """True when a flat state dict uses the shard-payload key format."""
    return bool(flat_dict) and all(_SEP in k for k in flat_dict)


def save_sharded(tree, directory, name):
    """Write this rank's replica-0 pieces of ``tree`` to
    ``{directory}/{name}_shards_p{rank}.npz``. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    out = os.path.join(directory, f"{name}_shards_p{state.rank}.npz")
    np.savez(out, **shard_payload(tree))
    return out


class _CatalogBase:
    """Shared reassembly logic over a ``key -> [(src, npz_key, bounds)]``
    entry map; subclasses provide ``_read``."""

    def keys(self):
        return set(self.entries)

    def _index_entries(self, keyed_sources):
        # keyed_sources: iterable of (src_handle_index, iterable of npz_keys)
        self.entries = {}
        for fi, npz_keys in keyed_sources:
            for npz_key in npz_keys:
                key, _, idx = npz_key.rpartition(_SEP)
                bounds = None if idx == "full" else json.loads(idx)
                self.entries.setdefault(key, []).append((fi, npz_key, bounds))

    def _extent(self, key):
        """The global shape of ``key``: the largest stored stop on each
        dimension (None for a whole leaf stored as ``full``)."""
        entries = self.entries[key]
        if any(b is None for _, _, b in entries):
            return None
        ndim = max(len(b) for _, _, b in entries)
        return tuple(max(b[i][1] for _, _, b in entries if len(b) > i) for i in range(ndim))

    def assemble(self, key, index, shape, dtype=None):
        """Materialize the slice ``index`` (a tuple of slices) of global
        array ``key`` as a numpy array of ``dtype`` (None: as stored) from
        the stored pieces (only the overlapping pieces are read). bf16 moves
        as its bits. A piece that is the whole region comes back as read."""
        if key not in self.entries:
            raise SMPRuntimeError(f"Checkpoint is missing parameter '{key}'.")
        entries = self.entries[key]
        want = []
        for sl, dim in zip(index, shape):
            start = 0 if sl.start is None else sl.start
            stop = dim if sl.stop is None else sl.stop
            want.append((int(start), int(stop)))
        for fi, npz_key, bounds in entries:
            if bounds is None or [tuple(b) for b in bounds] == want:
                piece = np.asarray(self._read(fi, npz_key))
                if piece.shape == tuple(b - a for a, b in want) and (
                        dtype is None or piece.dtype == np.dtype(dtype)
                        or is_bf16(piece.dtype) and is_bf16(dtype)):
                    return piece if dtype is None else piece.view(np.dtype(dtype))
                break
        if dtype is None:
            dtype = np.asarray(self._read(*entries[0][:2])).dtype
        dtype = np.dtype(dtype)
        raw = is_bf16(dtype)

        def read(fi, npz_key):
            piece = np.asarray(self._read(fi, npz_key))
            if raw:
                return piece.view(np.uint16) if is_bf16(piece.dtype) else to_numpy(
                    to_torch(piece).bfloat16()).view(np.uint16)
            if is_bf16(piece.dtype):
                return to_torch(piece).float().numpy()
            return piece

        if not want:  # scalar
            out = np.array(read(*entries[0][:2]), dtype=np.uint16 if raw else dtype)
            return out.view(dtype) if raw else out
        out = np.empty([b - a for a, b in want], dtype=np.uint16 if raw else dtype)
        filled = 0
        for fi, npz_key, bounds in entries:
            if bounds is None:
                bounds = [[0, d] for d in shape]
            # overlap of saved piece with wanted region
            inter = []
            for (wa, wb), (sa, sb) in zip(want, bounds):
                a, b = max(wa, sa), min(wb, sb)
                if a >= b:
                    inter = None
                    break
                inter.append((a, b))
            if inter is None:
                continue
            piece = read(fi, npz_key)
            src = tuple(slice(a - sa, b - sa) for (a, b), (sa, _) in zip(inter, bounds))
            dst = tuple(slice(a - wa, b - wa) for (a, b), (wa, _) in zip(inter, want))
            out[dst] = piece[src]
            filled += int(np.prod([b - a for a, b in inter]))
        total = int(np.prod([b - a for a, b in want]))
        if filled < total:
            raise SMPRuntimeError(
                f"Sharded checkpoint pieces for '{key}' do not cover the "
                f"requested region {want} ({filled}/{total} elements)."
            )
        return out.view(dtype) if raw else out

    def coverage(self):
        """Metadata-only coverage report: ``{key: (covered, total)}``
        element counts per logical array, from the stored bounds without
        decompressing any piece. ``covered < total`` means a hole (a rank's
        file is absent), ``covered > total`` overlapping pieces (mixed
        checkpoints in one directory). The global extent is inferred as the
        max stored stop per dim, so a missing tail is caught by the file
        census of ``verify_complete`` and by ``assemble``."""
        out = {}
        for key, entries in self.entries.items():
            if any(b is None for _, _, b in entries):
                out[key] = (1, 1)
                continue
            ndim = max(len(b) for _, _, b in entries)
            dims = [0] * ndim
            vol = 0
            for _, _, bounds in entries:
                for i, (_, stop) in enumerate(bounds):
                    dims[i] = max(dims[i], stop)
                v = 1
                for a, b in bounds:
                    v *= b - a
                vol += v
            total = 1
            for d in dims:
                total *= d
            out[key] = (vol, total)
        return out

    def verify_complete(self, what="checkpoint", expected_files=None):
        """Raise (before any deferred load is stashed) when coverage is
        wrong: a hole, an overlap (duplicate bounds count as one), or fewer
        shard files than the ``expected_files`` writer census saved in
        ``smp_config.pt``."""
        if expected_files is not None:
            nfiles = len(getattr(self, "paths", ()))
            if nfiles < expected_files:
                raise SMPRuntimeError(
                    f"{what}: found {nfiles} shard file(s) but the "
                    f"checkpoint was written by {expected_files} "
                    "process(es) — a peer's file is missing (never landed "
                    "on this filesystem, or lost). Bounds coverage cannot "
                    "see a missing tail shard, so the file census is "
                    "authoritative."
                )
        cov = self.coverage()
        bad = {k: c for k, c in cov.items() if c[0] != c[1]}
        dup = set()
        for key, entries in self.entries.items():
            seen = set()
            for _, _, bounds in entries:
                if bounds is None:
                    continue  # 'full' pieces are replicated by design
                sig = tuple(map(tuple, bounds))
                if sig in seen:
                    dup.add(key)
                    break
                seen.add(sig)
        for k in dup:
            bad.setdefault(k, (cov[k][0] + 1, cov[k][1]))
        if bad:
            gaps = sorted(k for k, c in bad.items() if c[0] < c[1])
            overlaps = sorted(k for k, c in bad.items() if c[0] > c[1])
            parts = []
            if gaps:
                parts.append(
                    "missing pieces (a rank's shard file is absent or was "
                    "never written) for: " + ", ".join(
                        f"'{k}' ({cov[k][0]}/{cov[k][1]} elements)" for k in gaps
                    )
                )
            if overlaps:
                parts.append(
                    "overlapping pieces (mixed checkpoints in one "
                    "directory?) for: " + ", ".join(
                        f"'{k}' ({cov[k][0]}/{cov[k][1]} elements)" for k in overlaps
                    )
                )
            raise SMPRuntimeError(f"{what}: " + "; ".join(parts))

    def load_tree(self, target=None, device=None):
        """``{key: tensor}`` for every key of ``target`` (a flat ``{key:
        tensor or array}`` dict giving each leaf's shape and dtype; None:
        every stored key at its stored extent and dtype), each leaf
        assembled whole from the pieces that cover it, as torch tensors on
        ``device`` (default: the CPU)."""
        out = {}
        for key in (target if target is not None else self.entries):
            if target is not None:
                leaf = target[key]
                shape = tuple(leaf.shape)
                dtype = numpy_dtype(leaf.dtype) if isinstance(leaf, torch.Tensor) else np.dtype(leaf.dtype)
            else:
                shape, dtype = self._extent(key), None
            if shape is None:  # stored whole
                arr = np.asarray(self._read(*self.entries[key][0][:2]))
            else:
                arr = self.assemble(key, tuple(slice(0, d) for d in shape), shape, dtype)
            t = to_torch(arr)
            out[key] = t.to(device) if device is not None else t
        return out

    def close(self):
        pass


class ShardCatalog(_CatalogBase):
    """Lazy view over all shard files of a checkpoint component. Files stay
    open as ``NpzFile`` handles; a piece is read only when a loader asks for
    a region it overlaps. ``close()`` releases the handles."""

    def __init__(self, directory, name):
        pattern = os.path.join(directory, f"{name}_shards_p*.npz")
        self.paths = sorted(glob.glob(pattern))
        if not self.paths:
            raise SMPRuntimeError(f"No sharded checkpoint files match {pattern}")
        self._files = [np.load(p, allow_pickle=False) for p in self.paths]
        self._index_entries((fi, f.files) for fi, f in enumerate(self._files))

    def _read(self, fi, npz_key):
        return self._files[fi][npz_key]

    def close(self):
        for f in self._files:
            f.close()


class InMemoryCatalog(_CatalogBase):
    """Catalog over an in-memory shard payload (``shard_payload`` output /
    ``local_state_dict`` round trips)."""

    def __init__(self, payload):
        self._payload = dict(payload)
        self._index_entries([(0, list(self._payload))])

    def _read(self, fi, npz_key):
        return self._payload[npz_key]
