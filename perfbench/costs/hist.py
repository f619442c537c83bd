"""Operations of the history model's step, counted from its equations
and shapes (see :mod:`perfbench.reference.hist`), and the shapes of its
erf kernel launches.

Forward, a halo at each of the ``T`` times: log10 Mh (2), the accretion
rate's log (1), the efficiency's two softplus ramps (14, a softplus as
3), log10 SFR (2), the row maximum (1), the rescaled power (2), the
trapezoid (3) and the running sum (1): 26.  A halo at each of the ``K``
epochs: the read out, its log10 and the row maximum back (2); and its
scatter width (4).  The terms that depend on the time alone (α(t), its
derivative) are left out.  Then the per-particle-sigma erf forward at
each epoch (:func:`.erf.fwd_ops`).  Backward: the erf backward at each
epoch (:func:`.erf.bwd_ops`) and twice the history's forward, the usual
count of a reverse pass over elementwise operations.  The chunks'
recomputation in the backward (the program rematerializes each chunk)
is not the model's work and is not counted.
"""
from __future__ import annotations

from perfbench.costs import erf

HISTORY_OPS_PER_TIME, EPOCH_OPS, SIGMA_OPS = 26, 2, 4


class Costs:
    def __init__(self, config: dict):
        self.n = int(config["num_halos"])
        self.chunk = int(config["chunk_size"])
        self.edges = int(config["bin_edges"]["count"])
        self.times = int(config["n_times"])
        self.epochs = len(config["obs_indices"])

    def _history(self) -> float:
        return self.n * (HISTORY_OPS_PER_TIME * self.times
                         + EPOCH_OPS * self.epochs + SIGMA_OPS)

    def forward_flops(self) -> float:
        return self._history() + self.epochs * erf.fwd_ops(
            self.n, self.edges, vec=True)

    def step_flops(self) -> float:
        return (self.forward_flops() + 2 * self._history()
                + self.epochs * erf.bwd_ops(self.n, self.edges, vec=True))

    def kernel(self, name: str):
        """``(particles, edges, vec)`` of one launch: one chunk at one
        epoch, a sigma a particle."""
        if name in ("erf_fwd", "erf_bwd"):
            return min(self.chunk, self.n), self.edges, True
        return None
