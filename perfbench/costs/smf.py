"""Operations of the SMF model's step, counted from its equations and
shapes (see :mod:`perfbench.reference.smf`), and the shapes of its erf
kernel launches.

One loss-and-gradient evaluation over ``N`` halos and ``E`` edges: the
mean log stellar mass (1 a halo), the erf forward kernel's counts
(:func:`.erf.fwd_ops`), its backward (:func:`.erf.bwd_ops`) and the
gradient of ``log_shmrat``, the sum of the halos' gradients (1 a halo).
The loss over ``E - 1`` bins and Adam's update of two parameters are
left out: a few hundred operations against ``~450 N``.
"""
from __future__ import annotations

from perfbench.costs import erf


class Costs:
    def __init__(self, config: dict):
        self.n = int(config["num_halos"])
        self.edges = int(config["bin_edges"]["count"])

    def forward_flops(self) -> float:
        return self.n + erf.fwd_ops(self.n, self.edges, vec=False)

    def step_flops(self) -> float:
        return (self.forward_flops()
                + erf.bwd_ops(self.n, self.edges, vec=False) + self.n)

    def kernel(self, name: str):
        """``(particles, edges, vec)`` of one launch of the kernel named
        ``name`` (``erf_fwd`` or ``erf_bwd``): the whole catalog, one
        launch an evaluation, a scalar sigma."""
        if name in ("erf_fwd", "erf_bwd"):
            return self.n, self.edges, False
        return None
