"""Cost-model auto-partitioner for pipeline stage assignment.

The PyTorch port's own copy of ``smdistributed_modelparallel_tpu/parallel/
module_partition.py`` (the port imports nothing of the JAX package); the
algorithms and their results are the same, held against the JAX package's
by ``tests/test_torch_pipeline_partition.py``.

Parity target: reference ``torch/module_partition.py:182-905``
(``ModulePartitioner``). Reimplemented algorithms (clean-room, from the
surveyed behavior):

- cost model: cost(node) = memory_weight * normalized_memory +
  (1 - memory_weight) * normalized_time, where memory is
  3*param_bytes + activation_bytes (params+grads+opt-ish weighting as in the
  reference) and time is a traced/estimated execution time quantized to 100
  levels (``populate_cost`` / ``normalize_costs``,
  reference ``module_partition.py:488-569``);
- segmentation: children of a node are split into contiguous segments
  minimizing the maximum segment cost (DP, reference ``get_segments``
  ``:837-904``);
- device allocation: stages are allocated to segments by the d'Hondt
  highest-averages method proportionally to segment cost (reference
  ``dhondt_allocate`` ``:788-835``);
- recursion: each segment with >1 allocated stage is recursively split over
  its own children (BFS over the tree, reference ``partition_nodes``
  ``:331-381``).

The per-stage executors (``parallel/pipeline.py``,
``parallel/pipeline_1f1b.py``) run any contiguous split, even or not; this
module is the general assignment engine — used to validate/report
assignments, honor manual ``smp.set_partition`` pins, and choose the
contiguous boundaries when layer costs are uneven.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from smdistributed_modelparallel_tpu_torch.utils.exceptions import PartitionError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

TIME_QUANT_LEVELS = 100


@dataclass
class ModuleNode:
    """A partitionable unit (module or group of modules sharing params)."""

    name: str
    param_bytes: float = 0.0
    activation_bytes: float = 0.0
    time: float = 0.0
    children: List["ModuleNode"] = field(default_factory=list)
    cost: float = 0.0  # filled by populate_costs

    def subtree_sum(self, attr):
        return getattr(self, attr) + sum(c.subtree_sum(attr) for c in self.children)


def populate_costs(root, memory_weight):
    """Normalized blended cost per node (reference ``populate_cost`` /
    ``normalize_costs``)."""
    total_mem = root.subtree_sum("param_bytes") * 3 + root.subtree_sum("activation_bytes")
    total_time = root.subtree_sum("time")

    def mem(node):
        return 3 * node.param_bytes + node.activation_bytes

    def quantized_time(node):
        if total_time <= 0:
            return 0.0
        q = round(node.time / total_time * TIME_QUANT_LEVELS) / TIME_QUANT_LEVELS
        return q

    def visit(node):
        m = mem(node) / total_mem if total_mem > 0 else 0.0
        node.cost = memory_weight * m + (1.0 - memory_weight) * quantized_time(node)
        for c in node.children:
            visit(c)

    visit(root)
    return root


def subtree_cost(node):
    return node.cost + sum(subtree_cost(c) for c in node.children)


def dhondt_allocate(num_devices, costs):
    """Allocate num_devices proportionally to costs (d'Hondt highest
    averages). Every segment with positive cost gets at least one device if
    possible; returns a list of allocations summing to num_devices."""
    n = len(costs)
    alloc = [0] * n
    if n == 0:
        return alloc
    for _ in range(num_devices):
        best, best_q = 0, -1.0
        for i, c in enumerate(costs):
            q = c / (alloc[i] + 1)
            if q > best_q:
                best, best_q = i, q
        alloc[best] += 1
    return alloc


def min_max_segments(costs, k):
    """Split `costs` into at most k contiguous segments minimizing the max
    segment sum. Returns list of (start, end) half-open ranges.

    DP over (i, j): best achievable max-cost splitting the first i items
    into j segments (reference ``get_segments``).
    """
    n = len(costs)
    k = min(k, n)
    if n == 0:
        return []
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    INF = float("inf")
    best = [[INF] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(1, n + 1):
            for s in range(j - 1, i):
                seg = prefix[i] - prefix[s]
                cand = max(best[s][j - 1], seg)
                if cand < best[i][j]:
                    best[i][j] = cand
                    cut[i][j] = s
    # Choose the smallest number of segments achieving the optimum at k.
    segments = []
    i, j = n, k
    while j > 0:
        s = cut[i][j]
        segments.append((s, i))
        i, j = s, j - 1
    segments.reverse()
    # Drop degenerate empty segments (possible when k > n).
    return [(a, b) for a, b in segments if b > a]


def min_max_segments_pinned(costs, k, pins):
    """Split `costs` into exactly k contiguous (possibly empty) segments
    minimizing the max segment sum, subject to pins {item_index: segment}.

    Used for manual ``smp.set_partition`` layer pins: the pinned layer must
    land in its pinned stage while the rest of the boundary placement stays
    cost-optimal. Returns k (start, end) half-open ranges covering [0, n).
    """
    n = len(costs)
    for i, s in pins.items():
        if not (0 <= s < k):
            raise PartitionError(f"Pin {i}->{s} out of range [0, {k}).")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def feasible(a, b, seg):
        """Items [a, b) may live in segment `seg`: every pinned item inside
        is pinned to `seg`, and no item pinned to `seg` lies outside later
        handling (checked globally by the DP structure)."""
        for i in range(a, b):
            if i in pins and pins[i] != seg:
                return False
        return True

    INF = float("inf")
    # best[i][j]: minimized max-cost covering the first i items with the
    # first j segments, all pins among them satisfied.
    best = [[INF] * (k + 1) for _ in range(n + 1)]
    cut = [[-1] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(0, n + 1):
            for s in range(0, i + 1):
                if best[s][j - 1] == INF:
                    continue
                if not feasible(s, i, j - 1):
                    continue
                # Items pinned to segment j-1 must not remain beyond i.
                if any(pins.get(t) == j - 1 for t in range(i, n)):
                    continue
                seg_cost = prefix[i] - prefix[s]
                cand = max(best[s][j - 1], seg_cost)
                if cand < best[i][j]:
                    best[i][j] = cand
                    cut[i][j] = s
    if best[n][k] == INF:
        raise PartitionError(
            f"No contiguous {k}-stage split satisfies pins {pins}: pins must "
            "be non-decreasing in layer order."
        )
    segments = []
    i, j = n, k
    while j > 0:
        s = cut[i][j]
        segments.append((s, i))
        i, j = s, j - 1
    segments.reverse()
    return segments


class ModulePartitioner:
    """Assign pipeline stages to a module-cost tree.

    Args:
      root: ModuleNode tree (costs not yet normalized).
      num_stages: pipeline_parallel_degree.
      memory_weight: blend factor (config ``memory_weight``).
      manual: dict name -> stage pins (``smp.set_partition``).
    """

    def __init__(self, root, num_stages, memory_weight=0.8, manual=None):
        self.root = root
        self.num_stages = num_stages
        self.memory_weight = memory_weight
        self.manual = dict(manual or {})

    def partition(self):
        populate_costs(self.root, self.memory_weight)
        assignment = {}
        # BFS: (node, stage_set) — a node with one stage pins its whole
        # subtree; multiple stages recurse over children.
        queue = [(self.root, list(range(self.num_stages)))]
        while queue:
            node, stages = queue.pop(0)
            if node.name in self.manual:
                stages = [self.manual[node.name]]
            if len(stages) == 1 or not node.children:
                self._assign_subtree(node, stages[0], assignment)
                continue
            assignment[node.name] = stages[0]
            child_costs = [subtree_cost(c) for c in node.children]
            segments = min_max_segments(child_costs, len(stages))
            allocs = dhondt_allocate(
                len(stages),
                [sum(child_costs[a:b]) for a, b in segments],
            )
            pos = 0
            for (a, b), count in zip(segments, allocs):
                seg_stages = stages[pos:pos + count]
                pos += count
                if not seg_stages:
                    seg_stages = [stages[min(pos, len(stages) - 1)]]
                for child in node.children[a:b]:
                    queue.append((child, seg_stages))
        return assignment

    def _assign_subtree(self, node, stage, assignment):
        assignment[node.name] = stage
        for c in node.children:
            self._assign_subtree(c, stage, assignment)


def uniform_layer_boundaries(layer_costs, num_stages):
    """Contiguous stage boundaries over a layer sequence minimizing max
    stage cost — used by the pipeline executor when layer costs are uneven
    but a contiguous split is required."""
    segments = min_max_segments(layer_costs, num_stages)
    if len(segments) != num_stages:
        # pad by splitting the largest segments is overkill; fall back to even
        n = len(layer_costs)
        per = n // num_stages
        segments = [(i * per, (i + 1) * per) for i in range(num_stages)]
        segments[-1] = (segments[-1][0], n)
    return segments
