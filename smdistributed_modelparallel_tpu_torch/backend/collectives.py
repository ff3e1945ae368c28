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
  send and receive around a ring deadlocks. ``ppermute_start`` posts them
  and returns a ``PendingPermute`` to wait on later, so that a ring can
  issue its next hop before the work it should hide under.
- ``send(x, dst, tag)`` / ``recv(shape, dtype, src, tag, device)``: the
  pipeline's point-to-point transfers to one neighbour. A send is posted
  and returns a ``PendingSend`` (the stage goes on computing); a receive
  blocks until the tensor sent under the same tag arrives. The forward
  direction (``tag`` even) and the backward one (odd) travel over two
  process groups, so that under NCCL, which matches a pair's transfers in
  order, a stage's sends one way never wait behind its receives the other
  way. ``send_status``/``recv_status`` move a small host header of each
  transfer (whether the sender failed, and why) over a gloo group, and
  ``all_gather_object`` gathers a picklable object over it: the pipeline's
  step-end agreement, and the last stage's output tree;
- ``all_to_all(x, split_dim, concat_dim)``: ``lax.all_to_all(...,
  tiled=True)``: chunk i of ``split_dim`` goes to member i, and the chunks
  received are concatenated along ``concat_dim`` in member order.
- ``all_gather(x, dim)`` (tiled; any dtype, the MoE's int32 routing choices
  among them), ``all_reduce(x)`` (sum or ``op``, in place), ``reduced(x)``
  (the same into a new tensor) and ``reduce_scatter(x, dim)`` (under gloo an
  all-reduce, then the member's chunk).

``all_to_all`` is the differentiable exchange (its backward is the inverse
exchange) that Ulysses attention and the MoE's expert dispatch share. The
tensor-parallel layers use Megatron's differentiable regions over the tp
group (``copy_to_tp``, ``reduce_from_tp``, ``gather_from_tp``,
``reduce_scatter_to_tp``, ``scatter_to_tp``; at the end of this module).
bf16 and fp16 travel as they are: gloo sums them as well as NCCL does.

The transport is decided once, when ``smp.init`` builds the groups, never
after a failure. Every rank all-gathers its device's UUID over the default
(gloo) group. A group whose tensors live on the CPU, or two of whose members
share one card, uses gloo; a CUDA tensor then goes to host memory before the
transfer, in pinned memory, and comes back after it (the copy out waits for
the card's queued work; the copy back is queued on the current stream before
whatever reads it). Otherwise the group uses NCCL on the card's tensors
directly. NCCL refuses two ranks on one card, which is why one H100 runs two
cp ranks over gloo.

Host object collectives (``CollectiveCommunicator``, ``state.comm``): the
JAX package's control plane between processes, over the native message bus
(``backend/native.py``). ``smp.send``/``smp.recv_from`` are in-order
per-pair object streams (tx ``2*seq + 1``); ``broadcast``/``allgather`` over
a group go through its first member (framework tx ``2*seq``); ``barrier`` is
the bus's group barrier. Objects travel pickled, in the JAX package's frames,
so a frame one package sends is one the other decodes. The JAX package runs
its full-world broadcast, allgather and barrier as device collectives; the
port has one process a device, so every group, the world included, rides the
bus. The one exchange that cannot, the bus endpoints themselves, runs over
the default ``torch.distributed`` group at ``smp.init``
(``initialize_bus``). ``SMP_COLLECTIVE_TIMEOUT`` bounds each bus wait of a
collective (a typed ``SMPCollectiveTimeout``), and the default group's gloo
timeout (``backend/state.py``).
"""

import atexit
import os
import pickle
import socket
import time
from enum import Enum

import torch
import torch.distributed as dist

from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.resilience.supervisor import _collective_timeout
from smdistributed_modelparallel_tpu_torch.utils.exceptions import (
    SMPCollectiveTimeout,
    SMPRuntimeError,
    SMPWatchdogTimeout,
)
from smdistributed_modelparallel_tpu_torch.utils import profiling
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_comm, record_sync_mark, telemetry, watchdog

logger = get_logger()

def _payload_size(obj):
    """Bytes of ``obj`` for the comm-volume counters where nothing is
    pickled: buffers, arrays and tensors by their size, anything else by
    one pickle (0 when it does not pickle)."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    try:
        return len(pickle.dumps(obj))
    except Exception:
        return 0


class CommGroup(Enum):
    """Parity: reference ``backend/collectives.py:15-58``."""

    WORLD = 0
    PP_GROUP = 1
    TP_GROUP = 2
    DP_GROUP = 3
    RDP_GROUP = 4
    MP_GROUP = 5
    CP_GROUP = 6  # TPU extension


class RankType(Enum):
    WORLD_RANK = 0
    PP_RANK = 1
    TP_RANK = 2
    DP_RANK = 3
    RDP_RANK = 4
    MP_RANK = 5


def _local_ip():
    """This host's address for peer connections: ``SMP_BUS_HOST``; the
    loopback when the job's master (``MASTER_ADDR``) is on this host; else
    the address of the interface the route to the master takes (a UDP
    socket's connect sends nothing)."""
    override = os.environ.get("SMP_BUS_HOST")
    if override:
        return override
    master = os.environ.get("MASTER_ADDR", "").strip()
    if not master or master in ("localhost", "127.0.0.1", "::1"):
        return "127.0.0.1"
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect((master, 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


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

    def __init__(self, ranks, pg, transport, rank, device=None, back_pg=None, host_pg=None):
        self.ranks = list(ranks)
        self.pg = pg
        self.back_pg = back_pg or pg  # the backward direction of send/recv
        self.host_pg = host_pg or pg  # gloo: the transfer headers and object collectives
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
        return self._buffer(x.shape, x.dtype, x.device)

    def _buffer(self, shape, dtype, device):
        """A receive buffer for a tensor of ``shape`` and ``dtype`` that
        lands on ``device``, where the transport writes it."""
        if self.transport == "gloo" and device.type == "cuda":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device if self.transport == "nccl" else device)

    @staticmethod
    def _home(y, like):
        """``y`` back on ``like``'s device: queued on the current stream
        before whatever reads it (the pinned block is not reused until the
        copy is done)."""
        return y if y.device == like.device else y.to(like.device, non_blocking=y.is_pinned())

    def ppermute(self, xs, perm):
        """``lax.ppermute`` of a tensor or a list of tensors: for each
        (src, dst) in ``perm`` (group indices), dst receives src's tensors."""
        return self.ppermute_start(xs, perm).wait()

    def ppermute_start(self, xs, perm):
        """``ppermute`` posted, not waited for: a ``PendingPermute`` whose
        ``wait()`` gives what ``ppermute`` returns. Work issued between the
        two runs while the transfer is in flight (the overlapped ring of
        ``ops/collective_matmul.py`` posts hop k + 1 before the product on
        hop k); the tensors sent must not change until ``wait()``."""
        single = isinstance(xs, torch.Tensor)
        xs = [xs] if single else list(xs)
        me = self.index
        out, ops, sent = None, [], None
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
        works = dist.batch_isend_irecv(ops) if ops else []
        return PendingPermute(works, out, xs, single, sent)

    def _p2p_pg(self, tag):
        return self.back_pg if tag & 1 else self.pg

    def send(self, x, dst, tag):
        """Post ``x`` to member ``dst`` under ``tag`` (odd: the backward
        direction) without waiting for it: a ``PendingSend``. ``x`` may
        change at once (the wire holds a copy under gloo, or ``x`` itself
        under NCCL, kept alive by the ``PendingSend``)."""
        wire = self._wire(x)
        if wire is x and self.transport == "gloo":
            wire = x.clone()  # gloo reads the buffer from its own thread
        return PendingSend([dist.isend(wire, self.ranks[dst], group=self._p2p_pg(tag), tag=tag)], wire)

    def recv(self, shape, dtype, src, tag, device):
        """The tensor member ``src`` sent under ``tag``, on ``device``:
        blocks until it has arrived (under NCCL, until the receive is queued
        on the current stream)."""
        like = torch.empty((0,), dtype=dtype, device=device)
        buf = self._buffer(shape, dtype, like.device)
        dist.recv(buf, self.ranks[src], group=self._p2p_pg(tag), tag=tag)
        return self._home(buf, like)

    def send_status(self, header, dst, tag):
        """Post the int32 host tensor ``header`` to member ``dst`` over the
        gloo group: a ``PendingSend``."""
        return PendingSend([dist.isend(header, self.ranks[dst], group=self.host_pg, tag=tag)], header)

    def recv_status(self, numel, src, tag):
        """The int32 header of ``numel`` elements member ``src`` posted under
        ``tag``; blocks until it arrives."""
        header = torch.empty((numel,), dtype=torch.int32)
        dist.recv(header, self.ranks[src], group=self.host_pg, tag=tag)
        return header

    def all_gather_object(self, obj):
        """Every member's ``obj`` (picklable), in member order, over the
        gloo group."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host_pg)
        return out

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

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """Sum (or ``op``) ``x`` over the group, in place; returns ``x``."""
        wire = self._wire(x)
        dist.all_reduce(wire, op=op, group=self.pg)
        if wire is not x:
            x.copy_(wire)
        return x

    def reduced(self, x, op=dist.ReduceOp.SUM):
        """A new tensor: ``x`` summed (or ``op``) over the group; ``x`` is
        left as it is."""
        wire = self._wire(x)
        if wire.data_ptr() == x.data_ptr():
            wire = wire.clone()
        dist.all_reduce(wire, op=op, group=self.pg)
        return self._home(wire, x)

    def reduce_scatter(self, x, dim):
        """``x`` summed over the group, this member's chunk of ``dim`` kept
        (``dim`` must split evenly). Under gloo an all-reduce, then the chunk."""
        if x.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split {self.size} ways")
        if self.transport == "nccl":
            send = self._wire(x.movedim(dim, 0))
            out = torch.empty((send.shape[0] // self.size,) + tuple(send.shape[1:]), dtype=send.dtype,
                              device=send.device)
            dist.reduce_scatter_tensor(out, send, group=self.pg)
            return out.movedim(0, dim).contiguous()
        return self.reduced(x).chunk(self.size, dim)[self.index].contiguous()

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


class PendingPermute:
    """A posted ``TensorGroup.ppermute``: ``wait()`` waits for its sends
    and receives once and returns the received tensors on their home
    devices (zeros where this member receives nothing)."""

    def __init__(self, works, received, xs, single, sent):
        self._works, self._received, self._xs, self._single = works, received, xs, single
        self._sent = sent  # the wire copies, alive until the sends complete
        self._out = None

    def wait(self):
        if self._out is None:
            for work in self._works:
                work.wait()
            received = self._received or [torch.zeros_like(x) for x in self._xs]
            self._out = [TensorGroup._home(r, x) for r, x in zip(received, self._xs)]
            self._works = self._sent = self._received = None
        return self._out[0] if self._single else self._out


class PendingSend:
    """A posted ``TensorGroup.send``: ``wait()`` waits for it once; the
    buffer stays alive until then."""

    def __init__(self, works, buffer):
        self._works, self._buffer = works, buffer

    def wait(self):
        for work in self._works or ():
            work.wait()
        self._works = self._buffer = None


class _AllToAll(torch.autograd.Function):
    """``TensorGroup.all_to_all``, differentiable: the backward is the
    inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.group.all_to_all(g.contiguous(), concat_dim, split_dim), None, None, None


def all_to_all(x, group, split_dim, concat_dim):
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``group``, differentiable."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


# -- the tensor-parallel regions ------------------------------------------
#
# Megatron's explicit, differentiable regions over the tp group, where the
# JAX package's sharding constraints let GSPMD place the collectives. Each
# takes ``group`` (the tp ``TensorGroup``; None at tp = 1, where every region
# is the identity). The host wall time of their exchanges (the pinned copies
# included) adds up in ``tp_comm_stats``.

tp_comm_stats = {"calls": 0, "seconds": 0.0}


def _timed(fn, *args):
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        tp_comm_stats["calls"] += 1
        tp_comm_stats["seconds"] += time.perf_counter() - t0


def _gather(group, x, dim, sizes):
    """``x`` gathered along ``dim`` over ``group``; ``sizes`` (each member's
    length of ``dim``, None when equal) lets the members differ: each pads
    to the longest, and the padding is dropped after the exchange."""
    if sizes is None or len(set(sizes)) == 1:
        return group.all_gather(x, dim)
    most = max(sizes)
    pad = list(x.shape)
    pad[dim] = most - x.shape[dim]
    full = group.all_gather(torch.cat([x, x.new_zeros(pad)], dim=dim), dim)
    keep = torch.cat([torch.arange(i * most, i * most + n, device=full.device) for i, n in enumerate(sizes)])
    return full.index_select(dim, keep)


def _chunk(group, x, dim, sizes):
    """This member's part of ``dim`` (``sizes`` as for ``_gather``)."""
    if sizes is None:
        return x.chunk(group.size, dim)[group.index].contiguous()
    lo = sum(sizes[:group.index])
    return x.narrow(dim, lo, sizes[group.index]).contiguous()


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated input entering
    per-rank partial work (a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _timed(ctx.group.reduced, g.contiguous()), None


class _AllReduceTP(torch.autograd.Function):
    """All-reduce forward; backward the identity (``grad="identity"``: the
    sum feeds replicated work, a row-parallel output) or an all-reduce
    (``grad="sum"``: it feeds each rank's own shard, as a sharded
    LayerNorm's moments do)."""

    @staticmethod
    def forward(ctx, x, group, sum_grad):
        ctx.group, ctx.sum_grad = group, sum_grad
        return _timed(group.reduced, x.contiguous())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (_timed(ctx.group.reduced, g.contiguous()) if ctx.sum_grad else g), None, None


class _AllGatherTP(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward a reduce-scatter along it
    (``split=False``: per-rank partial work follows, as QKV and fc after the
    sequence-parallel gather) or this rank's chunk of the gradient
    (``split=True``: replicated work follows, every rank holding the same
    gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim, split, sizes):
        ctx.group, ctx.dim, ctx.split, ctx.sizes = group, dim, split, sizes
        return _timed(_gather, group, x.contiguous(), dim, sizes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if ctx.split:
            return _chunk(ctx.group, g, ctx.dim, ctx.sizes), None, None, None, None
        if ctx.sizes is not None:  # uneven parts: the whole sum, then this rank's part
            return _chunk(ctx.group, _timed(ctx.group.reduced, g.contiguous()), ctx.dim, ctx.sizes), None, None, \
                None, None
        return _timed(ctx.group.reduce_scatter, g.contiguous(), ctx.dim), None, None, None, None


class _ReduceScatterTP(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather along it backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _timed(group.reduce_scatter, x.contiguous(), dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _timed(ctx.group.all_gather, g.contiguous(), ctx.dim), None, None


class _ScatterTP(torch.autograd.Function):
    """This rank's chunk of ``dim`` forward (a replicated tensor entering
    sharded work), all-gather along it backward."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return _chunk(group, x, dim, sizes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _timed(_gather, ctx.group, g.contiguous(), ctx.dim, ctx.sizes), None, None, None


def copy_to_tp(x, group):
    """Megatron's copy-to-tp region: identity forward, all-reduce backward."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x, group, sum_grad=False):
    """Megatron's reduce-from-tp region: all-reduce forward, identity
    backward (``sum_grad``: all-reduce backward too)."""
    return x if group is None else _AllReduceTP.apply(x, group, sum_grad)


def gather_from_tp(x, group, dim, split_grad=False, sizes=None):
    """All-gather along ``dim`` (the sequence under sequence parallelism,
    the last dim for ``split="dim"``); backward a reduce-scatter along it,
    or this rank's chunk with ``split_grad``. ``sizes``: uneven parts."""
    return x if group is None else _AllGatherTP.apply(x, group, dim, split_grad, sizes)


def reduce_scatter_to_tp(x, group, dim):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""
    return x if group is None else _ReduceScatterTP.apply(x, group, dim)


def scatter_to_tp(x, group, dim, sizes=None):
    """This rank's chunk of ``dim`` forward, all-gather backward."""
    return x if group is None else _ScatterTP.apply(x, group, dim, sizes)


class CollectiveCommunicator:
    """Object broadcast, allgather, barrier and point-to-point streams
    between the processes of the job (``state.comm``). ``dest``/``src`` and
    ``src`` of a broadcast are indices within the group's process list;
    the port runs one process a device, so a group's processes are its
    ranks."""

    def __init__(self):
        self._bus = None
        self._bus_failed = False
        self._send_seq = {}
        self._recv_seq = {}
        # Barrier ordinals of the sync marks, per group: apart from the
        # flight recorder's sequence, which goes away with the ring.
        self._barrier_seq = {}
        # Framework streams (even tx ids), apart from the user API's (odd).
        self._int_send_seq = {}
        self._int_recv_seq = {}

    @staticmethod
    def _world():
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        return state.world_size if state.initialized else 1

    @staticmethod
    def _me():
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        return state.rank if state.initialized else 0

    @property
    def bus(self):
        return self._bus

    # -- bus lifecycle --------------------------------------------------

    def initialize_bus(self, rank=None, world=None):
        """Bring the native bus up: listen locally, then one exchange of
        the endpoints over the default ``torch.distributed`` group that
        every rank enters whatever happened locally, so that a failed
        local bring-up (no library, a bind error) disables the bus on every
        rank alike. One process needs no exchange. Returns the bus, or None
        when the library is unavailable somewhere."""
        if self._bus is not None:
            return self._bus
        from smdistributed_modelparallel_tpu_torch.backend import native

        rank = self._me() if rank is None else rank
        world = self._world() if world is None else world
        lib = native.load()
        bus, endpoint = None, None
        if lib is not None:
            bus = native.MessageBus(lib)
            try:
                endpoint = f"{_local_ip()}:{bus.listen(0)}"
            except OSError as e:
                logger.warning("native bus listener failed: %s", e)
                bus.shutdown()
                bus = None
        if world == 1:
            if bus is None:
                self._bus_failed = True
                return None
            bus.connect(0, 1, [endpoint])
            # A multi-process bus is closed by the exit-status relay
            # (state.shutdown), which must run first; one process has none.
            atexit.register(self.shutdown)
        else:
            endpoints = [None] * world
            dist.all_gather_object(endpoints, endpoint)
            if any(e is None for e in endpoints):
                if bus is not None:
                    bus.shutdown()
                logger.warning("native message bus disabled: unavailable on at least one peer process.")
                self._bus_failed = True
                return None
            bus.connect(rank, world, endpoints)
        self._bus_failed = False
        self._bus = bus
        logger.debug("native message bus up at %s", endpoint)
        return bus

    def _get_bus(self, required_by):
        if self._bus is not None:
            return self._bus
        if self._world() == 1 and not self._bus_failed:
            bus = self.initialize_bus()
            if bus is not None:
                return bus
        raise SMPRuntimeError(
            f"{required_by} needs the native message bus (native/src/*.cc built into the port's _build/), which "
            "is not up: it failed to build or load, or SMP_DISABLE_NATIVE=1."
        )

    def shutdown(self):
        if self._bus is not None:
            self._bus.shutdown()
            self._bus = None
        self._send_seq.clear()
        self._recv_seq.clear()
        self._int_send_seq.clear()
        self._int_recv_seq.clear()
        self._barrier_seq.clear()

    # -- group -> processes ---------------------------------------------

    def group_processes(self, group=CommGroup.WORLD):
        """The processes of this process's ``group``, in group order. WORLD
        (and one process) is every process."""
        from smdistributed_modelparallel_tpu_torch.backend import core

        world = list(range(self._world()))
        if group in (None, CommGroup.WORLD) or len(world) == 1:
            return world
        getter = {
            CommGroup.PP_GROUP: core.get_pp_group,
            CommGroup.TP_GROUP: core.get_tp_group,
            CommGroup.DP_GROUP: core.get_dp_group,
            CommGroup.RDP_GROUP: core.get_rdp_group,
            CommGroup.MP_GROUP: core.get_mp_group,
            CommGroup.CP_GROUP: core.get_cp_group,
        }.get(group)
        return (list(getter()) or world) if getter is not None else world

    # -- collectives ----------------------------------------------------

    def broadcast(self, obj, group=CommGroup.WORLD, src=0):
        """Member ``src``'s picklable ``obj``, on every member of ``group``."""
        chaos.on_collective("broadcast", getattr(group, "name", group))
        procs = self.group_processes(group)
        if len(procs) == 1:
            record_comm("broadcast", group, _payload_size(obj), 1)
            return obj
        with watchdog.guard(f"broadcast/{getattr(group, 'name', group)}"), \
                profiling.region("collective/broadcast", track="host"):
            out, nbytes = self._bus_broadcast(obj, procs, src, group)
        record_comm("broadcast", group, nbytes, len(procs))
        return out

    def allgather(self, obj, group=CommGroup.WORLD):
        """Every member's picklable ``obj``, as a list in group order."""
        chaos.on_collective("allgather", getattr(group, "name", group))
        procs = self.group_processes(group)
        if len(procs) == 1:
            record_comm("allgather", group, _payload_size(obj), 1)
            return [obj]
        with watchdog.guard(f"allgather/{getattr(group, 'name', group)}"), \
                profiling.region("collective/allgather", track="host"):
            out, nbytes = self._bus_allgather(obj, procs, group)
        record_comm("allgather", group, nbytes, len(procs))
        return out

    def _member(self, procs, group, what):
        me = self._me()
        if me not in procs:
            raise SMPRuntimeError(f"{what} over {group} called from process {me}, which is not a member of that group.")
        return me

    def _bus_broadcast(self, obj, procs, src, group):
        me = self._member(procs, group, "broadcast")
        if src < 0 or src >= len(procs):
            raise SMPRuntimeError(f"broadcast src {src} out of range for group {group} ({len(procs)} processes).")
        root = procs[src]
        if me == root:
            payload = pickle.dumps(obj)
            for p in procs:
                if p != me:
                    self._int_send_bytes(p, payload)
            return obj, len(payload)
        return self._int_recv(root, group=group, phase="broadcast")

    def _bus_allgather(self, obj, procs, group):
        me = self._member(procs, group, "allgather")
        root = procs[0]
        if me == root:
            gathered, nbytes = [], 0
            for p in procs:
                if p == me:
                    gathered.append(obj)
                else:
                    o, n = self._int_recv(p, group=group, phase="allgather")
                    gathered.append(o)
                    nbytes += n
            payload = pickle.dumps(gathered)
            for p in procs:
                if p != me:
                    self._int_send_bytes(p, payload)
            return gathered, nbytes + len(payload)
        self._int_send_bytes(root, pickle.dumps(obj))
        return self._int_recv(root, group=group, phase="allgather")

    def _int_send_bytes(self, dest, payload):
        bus = self._get_bus("framework collective")
        seq = self._int_send_seq.get(dest, 0)
        bus.send_bytes(dest, payload, 2 * seq)
        self._int_send_seq[dest] = seq + 1
        return len(payload)

    def _int_recv(self, src, timeout_ms=-1, group=None, phase="recv"):
        bus = self._get_bus("framework collective")
        seq = self._int_recv_seq.get(src, 0)
        ct = _collective_timeout()
        if timeout_ms < 0 and ct is not None:
            timeout_ms = max(int(ct * 1000), 1)
        try:
            payload = bus.recv_bytes(src, 2 * seq, timeout_ms)
        except TimeoutError:
            g = getattr(group, "name", None) or str(group)
            raise SMPCollectiveTimeout(g, phase, flight_recorder.last_seq(g)) from None
        self._int_recv_seq[src] = seq + 1
        return pickle.loads(payload), len(payload)

    def barrier(self, name="smp_ccl_barrier", group=CommGroup.WORLD):
        """Barrier over the processes of ``group``, on the bus; then the
        group's sync mark (the cross-rank clock alignment point)."""
        procs = self.group_processes(group)
        gname = getattr(group, "name", None) or str(group)
        chaos.on_collective("barrier", gname)
        record_comm("barrier", group, 0, len(procs))
        seq = self._barrier_seq.get(gname, 0)
        self._barrier_seq[gname] = seq + 1
        if len(procs) > 1:
            self._member(procs, group, "barrier")
            ct = _collective_timeout()
            t0 = time.monotonic()
            if len(procs) == self._world():
                telemetry.set_phase(f"barrier/{name}")
            with profiling.region(f"collective/barrier/{gname}", track="host"), watchdog.guard(f"barrier/{gname}"):
                bus = self._get_bus(f"smp.barrier({group})")
                try:
                    if ct is None:
                        bus.barrier(procs)
                    else:
                        bus.barrier(procs, timeout_ms=max(int(ct * 1000), 1))
                except (OSError, SMPWatchdogTimeout) as e:
                    # Only a wait that used the configured deadline is a
                    # typed collective timeout; a bus that is down stays
                    # OSError.
                    if ct is not None and time.monotonic() - t0 >= 0.9 * ct:
                        raise SMPCollectiveTimeout(gname, "barrier", flight_recorder.last_seq(gname)) from e
                    raise
        self._record_sync(name, gname, seq)

    @staticmethod
    def _record_sync(name, gname, seq):
        from smdistributed_modelparallel_tpu_torch.backend.state import state

        record_sync_mark(name, gname, seq)
        tl = state.timeline
        if tl is not None and tl.enabled:
            tl.sync_mark(name, gname, seq)

    # -- point to point ---------------------------------------------------

    def send(self, obj, dest, group=CommGroup.WORLD):
        """Send a picklable object to process ``dest`` of ``group``; returns
        once it is queued (the bus's sender thread delivers it)."""
        gdest = self._resolve_peer(dest, group, "send dest")
        bus = self._get_bus("smp.send")
        seq = self._send_seq.get(gdest, 0)
        payload = pickle.dumps(obj)
        bus.send_bytes(gdest, payload, 2 * seq + 1)
        self._send_seq[gdest] = seq + 1  # only after the enqueue: a failed send may be retried
        record_comm("send", group, len(payload), 2)

    def recv_from(self, src, group=CommGroup.WORLD, timeout_ms=-1):
        """The next object, in order, that process ``src`` of ``group`` sent
        to this one."""
        gsrc = self._resolve_peer(src, group, "recv_from src")
        bus = self._get_bus("smp.recv_from")
        seq = self._recv_seq.get(gsrc, 0)
        telemetry.set_phase(f"recv_from/{gsrc}")
        payload = bus.recv_bytes(gsrc, 2 * seq + 1, timeout_ms)
        self._recv_seq[gsrc] = seq + 1
        record_comm("recv_from", group, len(payload), 2)
        return pickle.loads(payload)

    def poll(self, src, group=CommGroup.WORLD):
        """True when the next object from ``src`` has arrived."""
        gsrc = self._resolve_peer(src, group, "poll src")
        bus = self._get_bus("smp.poll")
        return bus.poll(gsrc, 2 * self._recv_seq.get(gsrc, 0) + 1)

    def _resolve_peer(self, idx, group, what):
        procs = self.group_processes(group)
        if idx < 0 or idx >= len(procs):
            raise SMPRuntimeError(f"{what} {idx} out of range for group {group} ({len(procs)} processes).")
        return procs[idx]
