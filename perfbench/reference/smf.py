"""Plain reference of the SMF model: PyTorch operations only, in the
dtype it is given (float64 for the comparison, bfloat16 for the control),
in blocks of halos so that it fits beside nothing else on the card.

The model (AlanPearl/multigrad ``tests/smf_example``): every halo of
log mass ``m_i`` holds a galaxy of mean log stellar mass ``m_i +
log_shmrat``, spread by a Gaussian of width ``sigma_logsm``; the sumstat
of bin ``b`` is the smoothed count over the volume and the bin width,

    y_b = Σ_i [Φ((e_{b+1} − m_i − p0)/σ) − Φ((e_b − m_i − p0)/σ)] / V / Δe_b,

and the loss the mean squared gap of ``log10 y`` and the log10 of the
target, the sumstats at the truth.  The gradient is the two-stage
chain rule: ``y`` summed over all blocks first, then ``dL/dy``, then one
vector-Jacobian product a block.  Imports nothing of the program.
"""
from __future__ import annotations

import math

#: Halos a block.
BLOCK = 10_000_000


class Reference:
    """The SMF fit's loss and gradient over ``inputs["log_halo_masses"]``.

    ``half=True`` is the fault "half of the batch left out, the mean
    taken over the rest": the sumstats of the loss come from the first
    half of the halos, over half the volume (the target stays whole)."""

    def __init__(self, config: dict, inputs: dict, dtype, half=False):
        import torch
        self.dtype = dtype
        self.x = inputs["log_halo_masses"]
        self.device = self.x.device
        e = config["bin_edges"]
        self.edges = torch.linspace(e["low"], e["high"], e["count"],
                                    dtype=torch.float64).to(
                                        self.device, dtype)
        self.widths = torch.diff(self.edges)
        n = config["num_halos"]
        self.volume = config["volume_per_halo"] * n
        self.half = False
        self.target = self.sumstats(torch.tensor(
            config["truth"], dtype=dtype, device=self.device))
        self.half = half

    def _block_sumstats(self, x, p):
        import torch
        v = x.to(self.dtype) + p[0]
        z = (self.edges[:, None] - v[None, :]) / (math.sqrt(2.0) * p[1])
        cdf = 0.5 * (1.0 + torch.erf(z))
        return (cdf[1:] - cdf[:-1]).sum(dim=1)

    def _blocks(self):
        x = self.x[: self.x.shape[0] // 2] if self.half else self.x
        return x.split(BLOCK)

    def _norm(self):
        return self.volume / (2 if self.half else 1) * self.widths

    def sumstats(self, params):
        import torch
        with torch.no_grad():
            counts = sum(self._block_sumstats(x, params)
                         for x in self._blocks())
        return counts / self._norm()

    def loss_from_sumstats(self, y):
        import torch
        return torch.mean((torch.log10(y) - torch.log10(self.target)) ** 2)

    def loss(self, params) -> float:
        return float(self.loss_from_sumstats(self.sumstats(params)))

    def loss_and_grad(self, params):
        import torch
        y = self.sumstats(params).requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss_from_sumstats(y)
            (dy,) = torch.autograd.grad(loss, y)
            dcounts = dy / self._norm()
            grad = torch.zeros_like(params)
            for x in self._blocks():
                p = params.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(
                    (self._block_sumstats(x, p) * dcounts).sum(), p)
                grad += g
        return loss.detach(), grad
