"""Input pipeline of the PyTorch port: batch sharding and device prefetch.

Counterpart of ``smdistributed_modelparallel_tpu/utils/data.py``:

- ``shard_batches(it)`` slices each batch down to this rank's share of the
  data-parallel batch. The JAX package slices by process, because there one
  process feeds one host; here a process is a rank, and the ranks of a
  context-parallel group share one batch (the step slices the sequence). So
  the slice is over the row degree (rdp x ep; at 1 batches pass through),
  which is what the step expects at rdp or ep > 1 (``step.py``).
- ``prefetch_to_device(it, size=2)`` stages up to ``size`` upcoming batches
  on the model's device from a background thread, so a batch's copy to the
  device overlaps the step before it. On a CUDA device each array leaf is
  pinned and copied on a side stream; the consumer's stream waits on the
  batch's event, and each tensor is recorded on the consumer's stream
  (``record_stream``), so the caching allocator cannot hand its memory to
  the side stream again while a step still reads it. The step's
  ``.to(model.device)`` then moves nothing. A CPU device gets the batches
  as CPU tensors; nothing else is placed on the CPU. A step that finds the
  queue empty waits for its batch; the goodput ledger attributes that wait
  to ``data_wait``.
- ``dataloader(it)`` composes both.

Batches are trees of dicts, lists and tuples; numpy arrays and tensors are
the array leaves, anything else (a scalar, a string) passes through.
"""

import queue
import threading

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.backend.split import tree_map
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput


def _is_array(leaf):
    return isinstance(leaf, (np.ndarray, torch.Tensor))


def shard_batches(iterator, batch_axis=0):
    """Slice each batch down to this rank's data-parallel share.

    Every rank must iterate the same global stream; the rank at row
    coordinate r of R keeps rows [r*B/R, (r+1)*B/R) of each array leaf's
    ``batch_axis``. The rows are sharded over (rdp, ep) in mesh order: r =
    rdp coordinate * ep + ep coordinate, R = rdp * ep (the cp ranks of one
    row coordinate keep the same rows; the step cuts their sequence
    shards). Leaves without that axis pass through, as do whole batches when
    R is 1."""
    topo = state.topology
    R = topo.rdp_size * topo.ep_size if topo is not None else 1
    coords = topo.coords(state.rank) if topo is not None else {}
    me = coords.get("rdp", 0) * (topo.ep_size if topo is not None else 1) + coords.get("ep", 0)
    for batch in iterator:
        if R == 1:
            yield batch
            continue

        def cut(leaf):
            if not _is_array(leaf) or leaf.ndim <= batch_axis:
                return leaf  # scalar / metadata leaf: nothing to slice
            B = leaf.shape[batch_axis]
            if B % R != 0:
                raise SMPValidationError(
                    f"Global batch dim {B} must be divisible by the data-parallel degree ({R})."
                )
            per = B // R
            idx = [slice(None)] * leaf.ndim
            idx[batch_axis] = slice(me * per, (me + 1) * per)
            return leaf[tuple(idx)]

        yield tree_map(cut, batch)


class prefetch_to_device:
    """Iterator wrapper staging up to ``size`` upcoming batches on the
    model's device (the device ``smp.init`` named when no model exists yet).

    Exceptions from the source iterator re-raise at the consumption point;
    once exhausted (or failed) the iterator keeps raising StopIteration (or
    the error). ``close()`` (also the context-manager exit) stops the fill
    thread and drops the staged batches."""

    _DONE = object()

    def __init__(self, iterator, size=2):
        if size < 1:
            raise SMPValidationError("prefetch size must be >= 1")
        if not state.initialized:
            raise SMPValidationError("smp.init must run before prefetch_to_device (the device comes from it).")
        from smdistributed_modelparallel_tpu_torch.model import resolve_device

        self.device = state.model.device if state.model is not None else resolve_device(None)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._q = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._terminal = None  # StopIteration or the source exception
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True, name="smp-prefetch")
        self._thread.start()

    def _put(self, item):
        """Bounded put that gives up when the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, batch):
        """(the batch with its array leaves on the device, the copies'
        event or None)."""

        def host(leaf):
            return torch.from_numpy(np.ascontiguousarray(leaf)) if isinstance(leaf, np.ndarray) else leaf

        if self._stream is None:
            return tree_map(lambda x: host(x).to(self.device) if _is_array(x) else x, batch), None

        def to_device(leaf):
            t = host(leaf)
            return (t.pin_memory() if t.device.type == "cpu" else t).to(self.device, non_blocking=True)

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            staged = tree_map(lambda x: to_device(x) if _is_array(x) else x, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _fill(self, iterator):
        try:
            for batch in iterator:
                if self._stop.is_set():
                    return
                if not self._put(self._stage(batch)):
                    return
        except Exception as e:  # noqa: BLE001 - re-raised at consumption
            self._put(e)
            return
        self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._terminal is not None:
            raise self._terminal
        led = goodput.ledger
        if led is not None and self._q.empty():
            # The input pipeline is BEHIND (the prefetch queue ran dry):
            # the blocked wait attributes to data_wait in the goodput
            # ledger. A ready batch skips the scope entirely.
            with led.scope("data_wait"):
                item = self._q.get()
        else:
            item = self._q.get()
        if item is self._DONE:
            self._terminal = StopIteration()
            raise StopIteration
        if isinstance(item, Exception):
            self._terminal = item
            raise item
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)

            def keep(leaf):
                if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                    leaf.record_stream(consumer)
                return leaf

            tree_map(keep, batch)
        return batch

    def close(self):
        """Stop the fill thread and drop staged batches."""
        self._stop.set()
        self._terminal = StopIteration()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def dataloader(iterator, size=2, batch_axis=0):
    """``prefetch_to_device(shard_batches(iterator))``: the standard input
    pipeline composition."""
    return prefetch_to_device(shard_batches(iterator, batch_axis=batch_axis), size=size)
