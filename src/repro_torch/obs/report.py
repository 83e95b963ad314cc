"""Structured explain-plan output for one partitioning run.

The port's NumPy copy of ``repro.obs.report``: the same code in the same
order of floating-point operations, so its results are bit-identical.

:class:`PartitionReport` is what ``registry.explain(name, gamma, m)``
returns: the partition itself (bit-identical to the plain
``registry.partition`` call — explain only *observes*), the quality
numbers the paper's evaluation is built on (bottleneck, ideal, imbalance),
the per-phase spans the tracer recorded, and the engine counter snapshot.
Stdlib-only so reports serialize and print anywhere the registry imports.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PartitionReport"]


@dataclasses.dataclass
class PartitionReport:
    algo: str
    m: int
    shape: tuple[int, int]
    bottleneck: float
    ideal: float               # total load / m (perfect-balance floor)
    imbalance: float           # bottleneck / ideal - 1
    wall_time: float           # seconds for the traced partition call
    partition: object          # the repro_torch.core.types.Partition itself
    spans: list[dict]          # chrome trace_event dicts (ph == "X")
    counters: dict[str, int]

    def span_totals(self) -> dict[str, float]:
        """Total duration (us) per span name, insertion-ordered."""
        out: dict[str, float] = {}
        for ev in self.spans:
            if ev.get("ph") == "X":
                out[ev["name"]] = round(
                    out.get(ev["name"], 0.0) + ev["dur"], 1)
        return out

    def to_dict(self, *, include_spans: bool = True) -> dict:
        """JSON-ready dict (the partition object itself is left out)."""
        d = {"algo": self.algo, "m": self.m, "shape": list(self.shape),
             "bottleneck": self.bottleneck, "ideal": self.ideal,
             "imbalance": self.imbalance, "wall_time": self.wall_time,
             "counters": dict(self.counters),
             "span_totals": self.span_totals()}
        if include_spans:
            d["spans"] = list(self.spans)
        return d

    def summary(self) -> str:
        lines = [
            f"{self.algo} m={self.m} on {self.shape[0]}x{self.shape[1]}: "
            f"Lmax={self.bottleneck:g} ideal={self.ideal:g} "
            f"LI={self.imbalance * 100:.2f}% "
            f"({self.wall_time * 1e3:.1f} ms)"]
        totals = self.span_totals()
        if totals:
            lines.append("  phases: " + ", ".join(
                f"{k}={v / 1e3:.2f}ms" for k, v in totals.items()))
        nz = {k: v for k, v in self.counters.items() if v}
        if nz:
            lines.append("  counters: " + ", ".join(
                f"{k}={v}" for k, v in nz.items()))
        return "\n".join(lines)
