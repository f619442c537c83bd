"""What every program builder shares: the seeded generator on the device
and the guesses of a traffic mix."""
from __future__ import annotations

import numpy as np


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` for the catalog of ``seed``: the
    same seed gives the same catalog."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 1) % (1 << 63))
    return gen


def inputs_made(device):
    """The catalog is made (its sort's scratch freed): the run's peak
    memory counts the program's from here, the catalog held."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


class Guesses:
    """The traffic's starting points, drawn in order from the seed:
    ``base + U(low, high)`` elementwise, where ``base`` is a list or
    ``"truth"`` and ``low`` and ``high`` are numbers or lists."""

    def __init__(self, spec: dict, truth, seed: int):
        base = truth if spec["base"] == "truth" else spec["base"]
        self.base = np.asarray(base, np.float64)
        self.low = np.broadcast_to(np.asarray(spec["low"], np.float64),
                                   self.base.shape)
        self.high = np.broadcast_to(np.asarray(spec["high"], np.float64),
                                    self.base.shape)
        self.rng = np.random.default_rng([int(seed), 2])

    def next(self) -> np.ndarray:
        return self.base + self.rng.uniform(self.low, self.high)
