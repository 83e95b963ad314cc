"""Streaming log-bucketed histogram (latency percentiles without samples).

The serve simulator tracks per-request latency for millions of requests;
keeping raw samples for a dashboard counter would defeat the chunked
streaming design.  :class:`LogHistogram` buckets values geometrically —
``per_decade`` buckets per factor of 10 — so ``add`` is one vectorized
``digitize`` per chunk and a percentile query walks the counts once.
Quantiles come back as the upper edge of the crossing bucket: relative
error is bounded by the bucket ratio (``10**(1/per_decade)``, ~7% at the
default 32/decade).  Exact percentiles, when needed, belong to whoever
still holds the samples (``serve.simulate.SimResult`` does); this is the
bounded-memory view ``obs`` exports to traces and dashboards.

The port's NumPy copy of ``repro.obs.hist``.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LogHistogram"]


class LogHistogram:
    """Fixed-range geometric histogram over ``[lo, hi)``.

    Values below ``lo`` land in an underflow bucket (reported as ``lo``),
    values at or above ``hi`` in an overflow bucket (reported as ``hi``).
    ``merge`` combines shards with identical bucketing.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e6,
                 per_decade: int = 32):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo, self.hi = float(lo), float(hi)
        self.per_decade = int(per_decade)
        self._log_lo = math.log10(self.lo)
        nb = int(math.ceil((math.log10(self.hi) - self._log_lo)
                           * self.per_decade))
        # +2: underflow bucket 0, overflow bucket nb+1
        self.counts = np.zeros(nb + 2, dtype=np.int64)
        self._nb = nb
        self.total_weight = 0.0

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def add(self, values) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if not v.size:
            return
        if (v < 0).any() or not np.isfinite(v).all():
            raise ValueError("histogram values must be finite and >= 0")
        self.total_weight += float(v.sum())
        with np.errstate(divide="ignore"):
            b = np.floor((np.log10(np.maximum(v, 1e-300)) - self._log_lo)
                         * self.per_decade).astype(np.int64) + 1
        np.clip(b, 0, self._nb + 1, out=b)
        b[v < self.lo] = 0
        np.add.at(self.counts, b, 1)

    def _edge(self, b: int) -> float:
        """Upper edge of bucket ``b`` (the reported quantile value)."""
        if b <= 0:
            return self.lo
        if b > self._nb:
            return self.hi
        return 10.0 ** (self._log_lo + b / self.per_decade)

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 100] (upper bucket edge)."""
        n = self.count
        if n == 0:
            return 0.0
        target = (q / 100.0) * n
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, max(target, 1), side="left"))
        return self._edge(b)

    @property
    def mean(self) -> float:
        n = self.count
        return self.total_weight / n if n else 0.0

    def merge(self, other: "LogHistogram") -> None:
        if (other.lo, other.hi, other.per_decade) != \
                (self.lo, self.hi, self.per_decade):
            raise ValueError("cannot merge histograms with different "
                             "bucketing")
        self.counts += other.counts
        self.total_weight += other.total_weight

    def summary(self) -> dict:
        """JSON-ready digest (what a bench record or trace arg carries)."""
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99), "p999": self.percentile(99.9)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = self.summary()
        return (f"LogHistogram(n={s['count']}, mean={s['mean']:.4g}, "
                f"p50={s['p50']:.4g}, p99={s['p99']:.4g})")
