"""3D partitions: boxes, their validity and loads, and rectilinear grids.

The port's partial NumPy copy of ``repro.core.threed``: the types the
SGORP planner (``core.sgorp``) returns.  ``Partition3D.loads`` is one
8-corner inclusion–exclusion gather over a shared 3D prefix, and
``is_valid`` one signed-corner scatter + 3D cumsum (the discrete
divergence trick) — no per-box Python slicing.  The slab partitioners of
the reference module (``SlabCache``, ``jag_m_heur_3d``, ``uniform_3d``,
``project_then_2d``) need its host 1D/2D engine and come with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .prefix import prefix_sum_3d

__all__ = ["Box", "Partition3D", "partition3d_from_grid"]


@dataclasses.dataclass(frozen=True)
class Box:
    """Half-open box [x0,x1) x [r0,r1) x [c0,c1)."""
    x0: int
    x1: int
    r0: int
    r1: int
    c0: int
    c1: int


@dataclasses.dataclass
class Partition3D:
    boxes: list[Box]
    shape: tuple[int, int, int]
    m_target: int | None = None  # requested processor count (>= len(boxes))

    @property
    def m(self) -> int:
        return self.m_target if self.m_target is not None else len(self.boxes)

    def _corners(self) -> np.ndarray:
        """(B, 6) int64 box corner matrix."""
        if not self.boxes:
            return np.zeros((0, 6), dtype=np.int64)
        return np.array([(b.x0, b.x1, b.r0, b.r1, b.c0, b.c1)
                         for b in self.boxes], dtype=np.int64)

    def loads(self, A: np.ndarray, *,
              gamma3: np.ndarray | None = None) -> np.ndarray:
        """Per-box loads by 8-corner inclusion–exclusion over one 3D
        prefix (pass a precomputed ``gamma3`` to skip the prefix build)."""
        if not self.boxes:
            return np.zeros(0)
        g = prefix_sum_3d(A) if gamma3 is None else gamma3
        c = self._corners()
        x0, x1, r0, r1, c0, c1 = (c[:, i] for i in range(6))
        return (g[x1, r1, c1] - g[x0, r1, c1] - g[x1, r0, c1]
                - g[x1, r1, c0] + g[x0, r0, c1] + g[x0, r1, c0]
                + g[x1, r0, c0] - g[x0, r0, c0]).astype(np.float64)

    def max_load(self, A: np.ndarray, *,
                 gamma3: np.ndarray | None = None) -> float:
        return float(self.loads(A, gamma3=gamma3).max(initial=0))

    def load_imbalance(self, A: np.ndarray, m: int | None = None, *,
                       gamma3: np.ndarray | None = None) -> float:
        m = m if m is not None else self.m
        g = prefix_sum_3d(A) if gamma3 is None else gamma3
        total = float(g[-1, -1, -1])
        if total == 0:
            return 0.0
        return float(self.loads(A, gamma3=g).max()) / (total / m) - 1.0

    def is_valid(self) -> bool:
        """Disjointness + coverage without painting per box: scatter the
        signed corner deltas of every box into an (n1+1, n2+1, n3+1)
        field, 3D-cumsum it back to paint counts, check all-ones."""
        n1, n2, n3 = self.shape
        c = self._corners()
        if ((c[:, 0] > c[:, 1]).any() or (c[:, 2] > c[:, 3]).any()
                or (c[:, 4] > c[:, 5]).any() or (c < 0).any()
                or (c[:, 1] > n1).any() or (c[:, 3] > n2).any()
                or (c[:, 5] > n3).any()):
            return False
        delta = np.zeros((n1 + 1, n2 + 1, n3 + 1), dtype=np.int64)
        for sx, xi in ((1, 0), (-1, 1)):
            for sr, ri in ((1, 2), (-1, 3)):
                for sc, ci in ((1, 4), (-1, 5)):
                    np.add.at(delta, (c[:, xi], c[:, ri], c[:, ci]),
                              sx * sr * sc)
        paint = np.cumsum(np.cumsum(np.cumsum(delta, axis=0), axis=1),
                          axis=2)[:n1, :n2, :n3]
        return bool((paint == 1).all())


def partition3d_from_grid(cuts1, cuts2, cuts3,
                          shape: tuple[int, int, int]) -> Partition3D:
    """Rectilinear partition from three per-axis cut vectors, row-major
    cell order (cell (i, j, k) -> processor ``ravel(i, j, k)``)."""
    c1 = np.asarray(cuts1, dtype=np.int64)
    c2 = np.asarray(cuts2, dtype=np.int64)
    c3 = np.asarray(cuts3, dtype=np.int64)
    boxes = [Box(int(c1[i]), int(c1[i + 1]), int(c2[j]), int(c2[j + 1]),
                 int(c3[k]), int(c3[k + 1]))
             for i in range(len(c1) - 1)
             for j in range(len(c2) - 1)
             for k in range(len(c3) - 1)]
    return Partition3D(boxes, tuple(shape))
