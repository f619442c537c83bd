"""What a driver hands back from its window."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Fit:
    """One fit of the window: its guess, its ``(nsteps + 1, ndim)``
    trajectory and the loss at its end as the program returned them, and
    the host clock at its submission and at its result on the host."""
    guess: np.ndarray
    traj: Optional[np.ndarray]
    loss: Optional[float]
    submitted: float
    done: float
    error: Optional[str] = None
    hops: Optional[dict] = None

    @property
    def failed(self) -> bool:
        return (self.error is not None or self.traj is None
                or not np.all(np.isfinite(self.traj))
                or not np.isfinite(self.loss))


@dataclass
class Record:
    """A window's end-to-end values (by metric name), the counters the
    per-layer readers take, and its fits."""
    end_to_end: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    fits: list = field(default_factory=list)
