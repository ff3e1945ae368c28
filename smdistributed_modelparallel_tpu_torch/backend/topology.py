"""Device topology: degrees, placement and mesh coordinates over ranks.

Counterpart of ``smdistributed_modelparallel_tpu/backend/topology.py``
(``DeviceTopology``) without a ``jax.sharding.Mesh``: each rank of the
``torch.distributed`` world is one device, and the mesh is the rank grid in
placement order (``DeviceMesh``, whose ``shape`` is the JAX mesh's). The same degree check refuses a configuration the device
count cannot hold (``DeviceCountError``), the same axis names and order give
each rank its coordinates (``coords``, ``cp_rank``), and ``axis_group`` lists
the ranks that share a rank's coordinates off one axis, in axis order.
``axes_group`` does the same off several axes: the data group (``DATA_AXES``,
every rank that holds other tokens of one microbatch), the expert replicas
(``EXPERT_REPLICA_AXES``, the ranks that hold the same experts) and the row
group (``ROW_AXES``, the ranks that hold other rows of one sequence shard).

The device count is ``_device_count_override`` when set (tests use it to
shrink the world), else the world size. The override may not exceed the
world: the JAX package cannot build a mesh over more devices than it has
either (its reshape of the device list fails).
"""

from smdistributed_modelparallel_tpu_torch.backend.ranker import Ranker, normalize_placement
from smdistributed_modelparallel_tpu_torch.utils.exceptions import DeviceCountError

# Canonical mesh axis names (the JAX package's).
PP_AXIS = "pp"
TP_AXIS = "tp"
RDP_AXIS = "rdp"
EP_AXIS = "ep"
CP_AXIS = "cp"

# Groups over several data axes (mesh order): every data rank, the ranks
# that hold the same experts, and the ranks that hold the same sequence shard.
DATA_AXES = (RDP_AXIS, EP_AXIS, CP_AXIS)
EXPERT_REPLICA_AXES = (RDP_AXIS, CP_AXIS)
ROW_AXES = (RDP_AXIS, EP_AXIS)


def _letter_axes(letter):
    if letter == "P":
        return [PP_AXIS]
    if letter == "T":
        return [TP_AXIS]
    return [RDP_AXIS, EP_AXIS, CP_AXIS]


class DeviceMesh:
    """The rank grid in place of a ``jax.sharding.Mesh``: ``shape`` is the
    same ``{axis: size}`` mapping (in mesh order), ``axis_names`` the axes
    and ``devices`` the grid of global ranks."""

    def __init__(self, axis_names, axis_sizes):
        import numpy as np

        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, axis_sizes))
        self.devices = np.arange(int(np.prod(axis_sizes))).reshape(axis_sizes)
        self.size = self.devices.size

    def __repr__(self):
        return f"DeviceMesh({self.shape})"


class DeviceTopology:
    """Degrees, the ``Ranker`` and the mesh axes over ``world_size`` ranks."""

    def __init__(self, cfg, world_size):
        self.cfg = cfg
        n = cfg._device_count_override or world_size
        if n > world_size:
            raise ValueError(
                f"_device_count_override={n} exceeds the {world_size} device(s) "
                "of the world (one device per rank)."
            )
        self.pp_size = cfg.pipeline_parallel_degree
        self.tp_size = cfg.tensor_parallel_degree
        self.cp_size = cfg.context_parallel_degree
        self.ep_size = cfg.expert_parallel_degree
        model_degree = self.pp_size * self.tp_size * self.cp_size * self.ep_size
        if n % model_degree != 0:
            raise DeviceCountError(model_degree, n)
        self.rdp_size = n // model_degree
        self.size = n
        self.d_size = self.rdp_size * self.cp_size * self.ep_size
        self.dp_size = self.tp_size * self.d_size

        self.placement = normalize_placement(cfg.placement_strategy)
        self.ranker = Ranker(self.placement, self.d_size, self.pp_size, self.tp_size)

        axis_names, axis_sizes = [], []
        for letter in self.placement:
            for ax in _letter_axes(letter):
                axis_names.append(ax)
                axis_sizes.append(getattr(self, f"{ax}_size"))
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(axis_sizes)
        self.mesh = DeviceMesh(self.axis_names, self.axis_sizes)

    def coords(self, rank):
        """Dict of mesh-axis name -> coordinate for a global rank index."""
        out = {}
        rem = rank
        # Unravel in placement (mesh) order: later axes vary fastest.
        for name, size in zip(reversed(self.axis_names), reversed(self.axis_sizes)):
            out[name] = rem % size
            rem //= size
        return out

    def cp_rank(self, rank):
        return self.coords(rank)[CP_AXIS]

    def axis_group(self, rank, axis):
        """Ranks sharing ``rank``'s coordinates on every mesh axis except
        ``axis`` (its group along that axis), in axis order."""
        return self.axes_group(rank, (axis,))

    def axes_group(self, rank, axes):
        """Ranks sharing ``rank``'s coordinates on every mesh axis not in
        ``axes``, in rank order: mesh order over ``axes``, the last fastest."""
        mine = self.coords(rank)
        group = []
        for r in range(self.size):
            c = self.coords(r)
            if all(c[a] == mine[a] for a in self.axis_names if a not in axes):
                group.append(r)
        return group

    def axes_size(self, axes):
        """The size of a group over ``axes``."""
        n = 1
        for a in axes:
            n *= getattr(self, f"{a}_size")
        return n

    def axis_groups(self, axis):
        """Every group along ``axis`` (an axis name or a tuple of them), each
        once, in rank order of its first member: the order in which every
        rank creates them."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        seen, groups = set(), []
        for r in range(self.size):
            g = tuple(self.axes_group(r, axes))
            if g not in seen:
                seen.add(g)
                groups.append(list(g))
        return groups

    def __repr__(self):
        dims = "x".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))
        return f"DeviceTopology({dims}, placement={self.placement})"
