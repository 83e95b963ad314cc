"""Data: the seekable synthetic token stream and the PIC particle feed
(``pipeline``), NumPy as in the reference."""
from __future__ import annotations

from . import pipeline

__all__ = ["pipeline"]
