"""Core types for rectangular partitioning (the port's NumPy copy of
``repro.core.types``).

Conventions
-----------
- The load matrix ``A`` is an ``(n1, n2)`` array of non-negative numbers.
- A :class:`Rect` is half-open: rows ``[r0, r1)`` x cols ``[c0, c1)``.
- ``Gamma`` (the 2D prefix-sum / summed-area table) is ``(n1+1, n2+1)`` with
  ``Gamma[i, j] == A[:i, :j].sum()`` so rectangle loads are four lookups.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Rect:
    """A half-open rectangle ``[r0, r1) x [c0, c1)`` assigned to one processor."""

    r0: int
    r1: int
    c0: int
    c1: int

    def __post_init__(self):
        if not (0 <= self.r0 <= self.r1 and 0 <= self.c0 <= self.c1):
            raise ValueError(f"malformed rectangle {self}")

    @property
    def area(self) -> int:
        return (self.r1 - self.r0) * (self.c1 - self.c0)

    def intersects(self, other: "Rect") -> bool:
        return (self.r0 < other.r1 and other.r0 < self.r1
                and self.c0 < other.c1 and other.c0 < self.c1)


@dataclasses.dataclass
class Partition:
    """A set of rectangles partitioning an ``(n1, n2)`` load matrix."""

    rects: list[Rect]
    shape: tuple[int, int]
    m_target: int | None = None  # requested processor count (>= len(rects))

    @property
    def m(self) -> int:
        return self.m_target if self.m_target is not None else len(self.rects)

    def loads(self, gamma: np.ndarray) -> np.ndarray:
        """Per-rectangle loads via four Gamma lookups each (vectorized)."""
        if not self.rects:
            return np.zeros(0)
        r = np.array([(q.r0, q.r1, q.c0, q.c1) for q in self.rects])
        r0, r1, c0, c1 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        return (gamma[r1, c1] - gamma[r0, c1] - gamma[r1, c0] + gamma[r0, c0])

    def max_load(self, gamma: np.ndarray) -> float:
        return float(self.loads(gamma).max(initial=0))

    def load_imbalance(self, gamma: np.ndarray) -> float:
        """Paper metric: ``Lmax / Lavg - 1`` (0 == perfectly balanced)."""
        total = float(gamma[-1, -1])
        if total == 0:
            return 0.0
        return self.max_load(gamma) / (total / max(self.m, 1)) - 1.0

    def is_valid(self) -> bool:
        """Disjointness + coverage (area test + paint test)."""
        n1, n2 = self.shape
        paint = np.zeros((n1, n2), dtype=np.int32)
        for q in self.rects:
            if q.r1 > n1 or q.c1 > n2:
                return False
            paint[q.r0:q.r1, q.c0:q.c1] += 1
        return bool((paint == 1).all())


def from_row_cuts_and_col_cuts(row_cuts: Sequence[int],
                               col_cuts_per_stripe: Sequence[Sequence[int]],
                               shape: tuple[int, int]) -> Partition:
    """Build a jagged partition from main-dimension cuts + per-stripe cuts."""
    rects = []
    for s in range(len(row_cuts) - 1):
        r0, r1 = int(row_cuts[s]), int(row_cuts[s + 1])
        cc = col_cuts_per_stripe[s]
        for t in range(len(cc) - 1):
            rects.append(Rect(r0, r1, int(cc[t]), int(cc[t + 1])))
    return Partition(rects, shape)


def from_grid(row_cuts: Sequence[int], col_cuts: Sequence[int],
              shape: tuple[int, int]) -> Partition:
    """Build a rectilinear (P x Q grid) partition."""
    return from_row_cuts_and_col_cuts(
        row_cuts, [col_cuts] * (len(row_cuts) - 1), shape)
