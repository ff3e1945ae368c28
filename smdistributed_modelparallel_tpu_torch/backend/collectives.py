"""Communication groups of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/backend/collectives.py``.
``CommGroup`` keeps the JAX package's enum. Where the JAX package lets XLA
place its tensor collectives on the mesh (``lax.ppermute``,
``lax.all_to_all``, ``lax.all_gather``, ``lax.psum``), the port runs them
eagerly over a ``torch.distributed`` group, one ``TensorGroup`` per mesh axis
of size > 1, with the same semantics:

- ``ppermute(xs, perm)``: every (src, dst) pair of group indices moves src's
  tensors to dst; a member that receives nothing gets zeros. All sends and
  receives of a call are posted together (``batch_isend_irecv``): a blocking
  send and receive around a ring deadlocks.
- ``all_to_all(x, split_dim, concat_dim)``: ``lax.all_to_all(...,
  tiled=True)``: chunk i of ``split_dim`` goes to member i, and the chunks
  received are concatenated along ``concat_dim`` in member order.
- ``all_gather(x, dim)`` (tiled) and ``all_reduce(x)`` (sum, in place).

The transport is decided once, when ``smp.init`` builds the groups, never
after a failure. Every rank all-gathers its device's UUID over the default
(gloo) group. A group whose tensors live on the CPU, or two of whose members
share one card, uses gloo; a CUDA tensor then goes to host memory before the
transfer, in pinned memory, and comes back after it (the copy out waits for
the card's queued work; the copy back is queued on the current stream before
whatever reads it). Otherwise the group uses NCCL on the card's tensors
directly. NCCL refuses two ranks on one card, which is why one H100 runs two
cp ranks over gloo.

The host object collectives of the JAX package (``broadcast``,
``allgather``, ``barrier``, ``send``/``recv_from`` over its C++ bus) belong
to the data-parallel slice and are not here.
"""

from enum import Enum

import torch
import torch.distributed as dist


class CommGroup(Enum):
    """Parity: reference ``backend/collectives.py:15-58``."""

    WORLD = 0
    PP_GROUP = 1
    TP_GROUP = 2
    DP_GROUP = 3
    RDP_GROUP = 4
    MP_GROUP = 5
    CP_GROUP = 6  # TPU extension


def device_key(device):
    """What two ranks compare to tell whether they share a card: the CUDA
    device's UUID, or ``"cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    return str(torch.cuda.get_device_properties(index).uuid)


def choose_transport(keys):
    """``"gloo"`` when any member is on the CPU or two members share a card,
    else ``"nccl"``."""
    if any(k == "cpu" for k in keys) or len(set(keys)) < len(keys):
        return "gloo"
    return "nccl"


class TensorGroup:
    """The tensor collectives of one group of ranks (``ranks``, in axis
    order) over the process group ``pg``."""

    def __init__(self, ranks, pg, transport, rank, device=None):
        self.ranks = list(ranks)
        self.pg = pg
        self.transport = transport
        self.device = torch.device(device or "cpu")  # this rank's device, where NCCL takes tensors
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)  # this rank's place in the group

    def __repr__(self):
        return f"TensorGroup(ranks={self.ranks}, transport={self.transport})"

    def _on_host(self, x):
        """Whether ``x`` travels through host memory: a CUDA tensor under
        gloo (in pinned memory, so the copies run at the link's rate)."""
        return self.transport == "gloo" and x.is_cuda

    def _wire(self, x):
        """``x`` as the transport takes it: contiguous, on the host under
        gloo, on the rank's card under NCCL."""
        x = x.contiguous()
        if self._on_host(x):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)  # waits for the work queued before it on x's stream
            return host
        if self.transport == "nccl" and not x.is_cuda:
            return x.to(self.device)
        return x

    def _empty(self, x):
        """A receive buffer for ``x``'s shape and type, where the transport
        writes it."""
        if self._on_host(x):
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return torch.empty(x.shape, dtype=x.dtype, device=self.device if self.transport == "nccl" else x.device)

    @staticmethod
    def _home(y, like):
        """``y`` back on ``like``'s device: queued on the current stream
        before whatever reads it (the pinned block is not reused until the
        copy is done)."""
        return y if y.device == like.device else y.to(like.device, non_blocking=y.is_pinned())

    def ppermute(self, xs, perm):
        """``lax.ppermute`` of a tensor or a list of tensors: for each
        (src, dst) in ``perm`` (group indices), dst receives src's tensors."""
        single = isinstance(xs, torch.Tensor)
        xs = [xs] if single else list(xs)
        me = self.index
        out, ops, sent = [torch.zeros_like(x) for x in xs], [], None
        for s, d in perm:
            if s == me and d == me:
                out = list(xs)  # kept in place: nothing to move
            elif s == me:
                sent = sent or [self._wire(x) for x in xs]
                ops += [dist.P2POp(dist.isend, t, self.ranks[d], group=self.pg) for t in sent]
            elif d == me:
                recv = [self._empty(x) for x in xs]
                ops += [dist.P2POp(dist.irecv, t, self.ranks[s], group=self.pg) for t in recv]
                out = recv
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = [self._home(r, x) for r, x in zip(out, xs)]
        return out[0] if single else out

    def all_to_all(self, x, split_dim, concat_dim):
        """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
        tiled=True)`` over the group."""
        if x.shape[split_dim] % self.size:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split {self.size} ways")
        send = self._wire(torch.stack(x.chunk(self.size, dim=split_dim)))
        got = torch.empty(send.shape, dtype=send.dtype, device=send.device, pin_memory=send.is_pinned())
        dist.all_to_all_single(got, send, group=self.pg)
        return torch.cat(self._home(got, x).unbind(0), dim=concat_dim)

    def all_gather(self, x, dim):
        """``lax.all_gather(x, axis=dim, tiled=True)`` over the group."""
        send = self._wire(x)
        parts = [torch.empty(send.shape, dtype=send.dtype, device=send.device) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.pg)
        return self._home(torch.cat(parts, dim=dim), x)

    def all_reduce(self, x):
        """Sum ``x`` over the group, in place; returns ``x``."""
        wire = self._wire(x)
        dist.all_reduce(wire, group=self.pg)
        if wire is not x:
            x.copy_(wire)
        return x

    def broadcast(self, x, src=0):
        """Overwrite ``x`` with member ``src``'s, in place; returns ``x``."""
        wire = self._wire(x)
        dist.broadcast(wire, self.ranks[src], group=self.pg)
        if wire is not x:
            x.copy_(wire)
        return x

    @torch.no_grad()
    def flat_(self, op, tensors):
        """Run ``op`` (``all_reduce`` or ``broadcast``) on ``tensors`` in
        place, as one flat buffer per dtype: one collective, not one a
        tensor."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = op(torch.cat([t.reshape(-1) for t in ts]))
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
