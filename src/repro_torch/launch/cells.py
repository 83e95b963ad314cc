"""The assigned (architecture x input-shape) grid: 40 cells.

The port's copy of ``repro.launch.cells`` (pure Python).

``long_500k`` requires sub-quadratic attention / bounded decode state: it
runs for mixtral-8x7b (pure sliding-window -> bounded KV), hymba-1.5b
(hybrid SWA+SSM) and mamba2-1.3b (SSM); it is skipped for the pure
full-attention archs (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses

from repro_torch import configs


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

LONG_OK = {"mixtral_8x7b", "hymba_1_5b", "mamba2_1_3b"}


def skip_reason(arch: str, shape: str) -> str | None:
    arch = configs.canonical(arch)
    if shape == "long_500k" and arch not in LONG_OK:
        return ("full-attention KV cache would grow O(seq); long-context "
                "decode is reserved for SSM/hybrid/SWA archs")
    return None


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in configs.ARCHS for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if skip_reason(a, s) is None]
