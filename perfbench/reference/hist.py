"""Plain reference of the history model: PyTorch operations only, in the
dtype it is given (float64 for the comparison, bfloat16 for the control),
in blocks of halos.  Imports nothing of the program.

The model (a diffmah-style accretion history with a diffstar-style star
formation efficiency; ten parameters ``p``): a halo of log mass ``m`` at
``T0 = 13.8`` Gyr grew as

    log10 Mh(t) = m + α(t) log10(t/T0),
    α(t)        = α_late + (α_early − α_late) s(t),
    s(t)        = sigmoid(k_t (lg_tc − log10 t)),

and forms stars at ``SFR(t) = ε(Mh) f_b dMh/dt`` with ``f_b = 0.156``,
``dMh/dt = Mh ln10 d log10 Mh/dt`` and

    log10 ε(Mh) = lgeps_max − (ε_lo/2 softplus(−2x) + ε_hi/2 softplus(2x)
                               − (ε_lo + ε_hi)/2 ln 2),   x = log10 Mh − logm_crit.

The stellar mass at an epoch is the trapezoid integral of the SFR over
the time grid (``n_times`` points log-spaced over [0.5, T0] Gyr) up to
it, each halo's SFR scaled by its largest value before the sum; its
log10 is the galaxy's mean log stellar mass, spread by a Gaussian of
width ``max(sigma_0 + sigma_slope (m − 13), 0.02)``.  The sumstats are
the smoothed counts over the volume and the bin width at each epoch of
``obs_indices``, and the loss the mean squared gap of their log10 and the
target's, both floored at 1e-12.  The gradient is the two-stage chain
rule, one vector-Jacobian product a block.
"""
from __future__ import annotations

import math

T0_GYR = 13.8
F_BARYON = 0.156
LN10 = math.log(10.0)
#: Halos a block.
BLOCK = 2_000_000


class Reference:
    """The history fit's loss and gradient over
    ``inputs["log_halo_masses"]``; ``half`` as in :mod:`.smf`."""

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
        self.t = torch.logspace(math.log10(0.5), math.log10(T0_GYR),
                                config["n_times"], dtype=torch.float64
                                ).to(self.device, dtype)
        self.obs = tuple(int(i) for i in config["obs_indices"])
        self.volume = config["volume_per_halo"] * config["num_halos"]
        self.half = False
        self.target = self.sumstats(torch.tensor(
            config["truth"], dtype=dtype, device=self.device))
        self.half = half

    def _block_sumstats(self, x, p):
        import torch
        import torch.nn.functional as F
        (a_early, a_late, lg_tc, k_t, lgeps_max, logm_crit, eps_lo, eps_hi,
         sigma_0, sigma_slope) = p
        m = x.to(self.dtype)[:, None]                       # (n, 1)
        t = self.t[None, :]                                 # (1, T)
        s = torch.sigmoid(k_t * (lg_tc - torch.log10(t)))
        alpha = a_late + (a_early - a_late) * s
        lam = torch.log10(t / T0_GYR)
        lg_mh = m + alpha * lam                             # (n, T)
        dalpha = -(a_early - a_late) * s * (1 - s) * k_t / (t * LN10)
        dlg_mh = lam * dalpha + alpha / (t * LN10)
        lg_dmh = lg_mh + torch.log10(torch.clamp(dlg_mh, min=1e-30) * LN10)
        xc = lg_mh - logm_crit
        ramp = (eps_lo / 2) * F.softplus(-2 * xc) \
            + (eps_hi / 2) * F.softplus(2 * xc)
        lg_eps = lgeps_max - (ramp - (eps_lo + eps_hi) / 2 * math.log(2.0))
        lg_sfr = lg_eps + math.log10(F_BARYON) + lg_dmh
        lg_ref = torch.amax(lg_sfr, dim=1, keepdim=True)
        sfr = torch.pow(10.0, lg_sfr - lg_ref)
        dt = torch.diff(self.t)[None, :]
        mstar = torch.cumsum(0.5 * (sfr[:, 1:] + sfr[:, :-1]) * dt, dim=1)
        cols = torch.stack([mstar[:, i - 1] for i in self.obs])   # (K, n)
        logsm = lg_ref[:, 0] + torch.log10(torch.clamp(cols, min=1e-30))
        sigma = torch.clamp(sigma_0 + sigma_slope * (m[:, 0] - 13.0),
                            min=0.02)
        z = (self.edges[None, :, None] - logsm[:, None, :]) \
            / (math.sqrt(2.0) * sigma)                      # (K, E, n)
        cdf = 0.5 * (1.0 + torch.erf(z))
        return (cdf[:, 1:] - cdf[:, :-1]).sum(dim=2)        # (K, B)

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
        return (counts / self._norm()).reshape(-1)

    def loss_from_sumstats(self, y):
        import torch

        def lg(v):
            return torch.log10(torch.clamp(v, min=1e-12))
        return torch.mean((lg(y) - lg(self.target)) ** 2)

    def loss(self, params) -> float:
        return float(self.loss_from_sumstats(self.sumstats(params)))

    def loss_and_grad(self, params):
        import torch
        y = self.sumstats(params).requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss_from_sumstats(y)
            (dy,) = torch.autograd.grad(loss, y)
            dcounts = dy.reshape(len(self.obs), -1) / self._norm()
            grad = torch.zeros_like(params)
            for x in self._blocks():
                p = params.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(
                    (self._block_sumstats(x, p) * dcounts).sum(), p)
                grad += g
        return loss.detach(), grad
