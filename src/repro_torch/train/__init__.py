"""Training: AdamW (``optim``) and atomic checkpoints (``checkpoint``).

The port of ``repro.train``; the step that joins them with a model's loss
is ``launch.steps.make_train_step``.
"""
from __future__ import annotations

from . import checkpoint, optim

__all__ = ["checkpoint", "optim"]
