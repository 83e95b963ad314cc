"""repro_torch.core — the paper's rectangular partitioners, ported.

The NumPy host engine (:mod:`.prefix`, :mod:`.search`, :mod:`.oned`,
:mod:`.stripecache`, :mod:`.rect`, :mod:`.jagged`, :mod:`.hier`,
:mod:`.hybrid`, :mod:`.threed`) is a copy of the reference's, bit-identical
to it; the device partitioners (:mod:`.device`) and the d-dimensional
SGORP planner (:mod:`.sgorp`) run on the card.  :mod:`.registry` puts
every one of them behind the paper's names.

Quick use::

    from repro_torch.core import prefix, registry
    A = prefix.pic_like_instance(512, 512, iteration=20_000)
    gamma = prefix.prefix_sum_2d(A)
    part = registry.partition("jag-m-heur-probe", gamma, m=6400)
    print(part.load_imbalance(gamma))
"""
from . import (hier, hybrid, jagged, oned, prefix, rect, registry, search,
               stripecache, types)
from .types import Partition, Rect

__all__ = ["hier", "hybrid", "jagged", "oned", "prefix", "rect", "registry",
           "search", "stripecache", "types", "Partition", "Rect"]
