"""Rank / group arithmetic under a placement strategy.

A copy of ``smdistributed_modelparallel_tpu/backend/ranker.py`` (which
imports numpy only): the reference's ``Ranker`` stride arithmetic over the
3-letter placement permutation, realized as a numpy rank grid with
``grid[coords] == rank``.

Conventions (same as reference):
- placement string is a permutation of "P" (pipeline), "D" (reduced data
  parallel), "T" (tensor); the right-most letter varies fastest across
  neighboring ranks. "cluster" == "DPT", "spread" == "TPD".
- dp is the composite of T and D; mp is the composite of P and T. In a
  composite, the letter appearing later in the placement string is the
  minor (fast-varying) component.
"""

import numpy as np

PLACEMENT_ALIASES = {"cluster": "DPT", "spread": "TPD"}


def normalize_placement(ps):
    return PLACEMENT_ALIASES.get(ps, ps)


class Ranker:
    def __init__(self, placement_strategy, rdp_size, pp_size, tp_size):
        self.ps = normalize_placement(placement_strategy)
        assert sorted(self.ps) == ["D", "P", "T"], f"bad placement {placement_strategy}"
        self.sizes = {"P": pp_size, "D": rdp_size, "T": tp_size}
        self.size = pp_size * rdp_size * tp_size
        shape = tuple(self.sizes[d] for d in self.ps)
        self._grid = np.arange(self.size).reshape(shape)
        self._coords = np.empty((self.size, 3), dtype=np.int64)  # columns follow self.ps
        for idx, rank in np.ndenumerate(self._grid):
            self._coords[int(rank)] = idx

    # -- single-dim ranks ----------------------------------------------

    def _coord(self, rank, dim):
        return int(self._coords[rank][self.ps.index(dim)])

    def get_pp_rank(self, rank):
        return self._coord(rank, "P")

    def get_tp_rank(self, rank):
        return self._coord(rank, "T")

    def get_rdp_rank(self, rank):
        return self._coord(rank, "D")

    # -- composite ranks -----------------------------------------------

    def _major_minor(self, a, b):
        """Of two dims, the one earlier in the placement string is major."""
        return (a, b) if self.ps.index(a) < self.ps.index(b) else (b, a)

    def _composite_rank(self, rank, a, b):
        major, minor = self._major_minor(a, b)
        return self._coord(rank, minor) + self.sizes[minor] * self._coord(rank, major)

    def get_dp_rank(self, rank):
        return self._composite_rank(rank, "T", "D")

    def get_mp_rank(self, rank):
        return self._composite_rank(rank, "P", "T")

    # -- groups ---------------------------------------------------------

    def _group(self, rank, dims):
        """All ranks sharing this rank's coordinates outside `dims`, in
        placement order (earlier letters outer)."""
        index = tuple(
            slice(None) if d in dims else self._coord(rank, d) for d in self.ps
        )
        return [int(r) for r in self._grid[index].ravel()]

    def get_pp_group(self, rank):
        return self._group(rank, "P")

    def get_tp_group(self, rank):
        return self._group(rank, "T")

    def get_rdp_group(self, rank):
        return self._group(rank, "D")

    def get_dp_group(self, rank):
        return self._group(rank, "TD")

    def get_mp_group(self, rank):
        return self._group(rank, "PT")

    def get_world_group(self):
        return list(range(self.size))

    # -- translations ---------------------------------------------------

    def translate(self, pp_rank, tp_rank, rdp_rank):
        coords = {"P": pp_rank, "T": tp_rank, "D": rdp_rank}
        return int(self._grid[tuple(coords[d] for d in self.ps)])

    def _decompose(self, comp_rank, a, b):
        major, minor = self._major_minor(a, b)
        return {minor: comp_rank % self.sizes[minor], major: comp_rank // self.sizes[minor]}

    def get_rdp_rank_from_dp_rank(self, dp_rank):
        return self._decompose(dp_rank, "T", "D")["D"]

    def get_tp_rank_from_dp_rank(self, dp_rank):
        return self._decompose(dp_rank, "T", "D")["T"]

    def get_pp_rank_from_mp_rank(self, mp_rank):
        return self._decompose(mp_rank, "P", "T")["P"]

    def get_tp_rank_from_mp_rank(self, mp_rank):
        return self._decompose(mp_rank, "P", "T")["T"]

    # -- grid access ------------------------------------------------------

    @property
    def grid(self):
        """(sizes in placement order) ndarray with grid[coords] == rank."""
        return self._grid
