"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips where
there is none.  The file imports no JAX (the GPU machine has none), so
it runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: forward max|err| within
2e-5·max|count|, gradients rtol 1e-3 with atol 1e-5·max|grad| (float32
sums over particles in another order); fused counts against dense rtol
1e-5, atol 1e-4.
"""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import (GalhaloHistModel, ParamTuple,
                                        SMFModel, make_galhalo_hist_data,
                                        make_smf_data)
from multigrad_tpu_torch.models import galhalo_hist as gh
from multigrad_tpu_torch.models.galhalo_hist import TRUTH as HIST_TRUTH
from multigrad_tpu_torch.ops import binned as tb
from multigrad_tpu_torch.ops import erf_kernels as ek
from multigrad_tpu_torch.ops import fused_kernels as fk
from multigrad_tpu_torch.ops import hist_kernels as hk
from multigrad_tpu_torch.ops.binned import binned_erf_counts
from tools.hist_card_vs_cpu import evaluate, evaluate_fed

pytestmark = pytest.mark.cuda
COT = np.arange(10.0, dtype=np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n=100_003, n_inf=1_000, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(9.5, 0.4, size=n).astype(np.float32)
    vals[-n_inf:] = np.inf
    edges = np.linspace(9, 10, 11).astype(np.float32)
    return (torch.tensor(vals, device=dev), torch.tensor(edges, device=dev),
            torch.tensor(0.2, device=dev), torch.tensor(COT, device=dev))


def _assert_close(got, want, rtol=1e-3):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=1e-5 * scale)


def test_kernels_match_plain(dev):
    v, e, s, g = _inputs(dev)
    fwd = ek.erf_counts_fwd_cuda(v, e, s.reshape(1))
    want = ek.erf_counts_fwd_plain(v, e, s)
    assert float((fwd - want).abs().max()) <= 2e-5 * float(want.abs().max())
    for got, ref in zip(ek.erf_counts_bwd_cuda(v, e, s.reshape(1), g),
                        ek.erf_counts_bwd_plain(v, e, s, g)):
        assert torch.isfinite(got).all()
        _assert_close(got, ref)


def test_forward_is_deterministic(dev):
    v, e, s, _ = _inputs(dev, n=1_000_003)
    a = ek.erf_counts_fwd_cuda(v, e, s.reshape(1))
    b = ek.erf_counts_fwd_cuda(v, e, s.reshape(1))
    assert torch.equal(a, b)


def test_autograd_launches_each_kernel_once(dev):
    v, e, s, g = _inputs(dev)
    v.requires_grad_()
    s.requires_grad_()
    before = (ek.erf_counts_fwd_cuda.launches,
              ek.erf_counts_bwd_cuda.launches)
    (binned_erf_counts(v, e, s) * g).sum().backward()
    torch.cuda.synchronize()
    assert (ek.erf_counts_fwd_cuda.launches,
            ek.erf_counts_bwd_cuda.launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.isfinite(v.grad).all() and torch.isfinite(s.grad)
    assert float(v.grad[-1]) == 0.0  # +inf padding is neutral


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    v, e, s, _ = _inputs(dev)
    with pytest.raises(ValueError, match="float32"):
        ek.erf_counts_fwd_cuda(v.double(), e, s.reshape(1))
    with pytest.raises(ValueError, match="contiguous"):
        ek.erf_counts_fwd_cuda(v[::2], e, s.reshape(1))
    with pytest.raises(ValueError, match="float32"):
        ek.erf_counts_fwd_cuda(v, e.cpu(), s.reshape(1))


def test_smf_on_card_matches_cpu(dev):
    params = ParamTuple(-1.0, 0.5)
    gpu = SMFModel(aux_data=make_smf_data(1_000_000, device=dev))
    cpu = SMFModel(aux_data=make_smf_data(1_000_000, device="cpu"))
    loss_g, grad_g = gpu.calc_loss_and_grad_from_params(params)
    loss_c, grad_c = cpu.calc_loss_and_grad_from_params(params)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-4)
    _assert_close(grad_g, grad_c)


def _vec_inputs(dev, n=100_003, n_inf=1_000, n_edges=14, seed=1):
    rng = np.random.default_rng(seed)
    vals = rng.normal(9.4, 0.9, size=n).astype(np.float32)
    vals[-n_inf:] = np.inf
    sig = rng.uniform(0.1, 0.32, size=n).astype(np.float32)
    edges = np.linspace(7.0, 11.75, n_edges).astype(np.float32)
    cot = rng.normal(size=n_edges - 1).astype(np.float32)
    return tuple(torch.tensor(x, device=dev) for x in (vals, edges, sig, cot))


def test_vec_sigma_kernels_match_plain(dev):
    v, e, s, g = _vec_inputs(dev)
    fwd = ek.erf_counts_fwd_vec_cuda(v, e, s)
    want = ek.erf_counts_fwd_plain(v, e, s)
    assert float((fwd - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(fwd, ek.erf_counts_fwd_vec_cuda(v, e, s))
    got = ek.erf_counts_bwd_vec_cuda(v, e, s, g)
    for a, b in zip(got, ek.erf_counts_bwd_plain(v, e, s, g)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        _assert_close(a, b)
    assert float(got[0][-1]) == 0.0 and float(got[2][-1]) == 0.0


def _dense_case(v, e, s, g):
    """The dense kernels against their plain versions, and every output
    the same bit for bit on a second call."""
    vec = s.dim() > 0
    fwd_k = ek.erf_counts_fwd_vec_cuda if vec else ek.erf_counts_fwd_cuda
    bwd_k = ek.erf_counts_bwd_vec_cuda if vec else ek.erf_counts_bwd_cuda
    s_k = s if vec else s.reshape(1)
    fwd = fwd_k(v, e, s_k)
    want = ek.erf_counts_fwd_plain(v, e, s)
    assert fwd.shape == want.shape
    assert float((fwd - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(fwd, fwd_k(v, e, s_k))
    got = bwd_k(v, e, s_k, g)
    again = bwd_k(v, e, s_k, g)
    for a, b, c in zip(got, ek.erf_counts_bwd_plain(v, e, s, g), again):
        assert a.shape == b.shape and torch.isfinite(a).all()
        _assert_close(a, b)
        assert torch.equal(a, c)
    return got


@pytest.mark.parametrize("n_edges", [2, 11, 14, 16, 17, 41])
@pytest.mark.parametrize("vec", [False, True])
def test_dense_kernels_every_edge_count(dev, vec, n_edges):
    # Exact-edge instances (2..16) and the capped ones (17, 41), a ragged
    # N with +inf padding, a scalar or a per-particle sigma.
    v, e, s, g = _vec_inputs(dev, n_edges=n_edges, seed=n_edges)
    s = s if vec else s[0].clone()
    dv, _, ds = _dense_case(v, e, s, g)
    assert float(dv[-1]) == 0.0
    if vec:
        assert float(ds[-1]) == 0.0


@pytest.mark.parametrize("vec", [False, True])
def test_dense_kernels_unaligned_values(dev, vec):
    # A view one float into its storage: the kernels' one-particle loop.
    v, e, s, g = _vec_inputs(dev, n=50_001)
    v, s = v[1:], (s[1:] if vec else s[0].clone())
    assert v.data_ptr() % 16 != 0
    _dense_case(v, e, s, g)


def _fused_case(v, e, s, g, window):
    """The fused kernels against their plain versions (counts within
    2e-5·max|count|, all three gradients rtol 1e-3, atol 1e-5·max|grad|),
    and every output the same bit for bit on a second call."""
    fwd = fk.fused_counts_fwd_cuda(v, e, s, window)
    want = fk.fused_counts_fwd_plain(v, e, s, window)
    assert fwd.shape == want.shape == (e.shape[0] - 1,)
    assert float((fwd - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(fwd, fk.fused_counts_fwd_cuda(v, e, s, window))
    got = fk.fused_counts_bwd_cuda(v, e, s, window, g, True)
    again = fk.fused_counts_bwd_cuda(v, e, s, window, g, True)
    for a, b, c in zip(got, fk.fused_counts_bwd_plain(v, e, s, window, g,
                                                      True), again):
        assert a.shape == b.shape and torch.isfinite(a).all()
        _assert_close(a, b)
        assert torch.equal(a, c)
    # Without the edges' gradient (the main path): the same dv and dsigma
    # bit for bit (one grid and block size either way; a scalar's sum
    # added up in the same order).
    dv, de, ds = fk.fused_counts_bwd_cuda(v, e, s, window, g)
    assert de is None and torch.equal(dv, got[0]) and torch.equal(ds, got[2])
    return got


# (edges, window, sigma range): the history's 41 edges at its window of 33
# and at others; per-thread columns at 256 (41
# edges), 128 (300) and 32 threads a block (1,000); per-warp rows at
# 16,384 edges, with sigmas that a window of 128 covers.
FUSED_SHAPES = {"E2_W2": (2, 2, (0.1, 0.32)), "E41_W33": (41, 33, (0.1, 0.32)),
                "E41_W2": (41, 2, (0.1, 0.32)), "E41_W41": (41, 41, (0.1, 0.32)),
                "E300_W128": (300, 128, (0.02, 0.1)),
                "E1000_W128": (1000, 128, (0.005, 0.03)),
                "E16384_W128": (16_384, 128, (0.0005, 0.003)),
                "E16384_W33": (16_384, 33, (0.0005, 0.003))}


@pytest.mark.parametrize("shape", sorted(FUSED_SHAPES))
@pytest.mark.parametrize("vec", [False, True])
def test_fused_kernels_match_plain(dev, vec, shape):
    n_edges, window, (lo, hi) = FUSED_SHAPES[shape]
    v, e, _, g = _vec_inputs(dev, n_edges=n_edges, seed=n_edges + window)
    rng = np.random.default_rng(window)
    s = torch.tensor(rng.uniform(lo, hi, v.shape[0]).astype(np.float32),
                     device=dev)
    s = s if vec else s[0].clone()
    dv, _, ds = _fused_case(v, e, s, g, window)
    assert float(dv[-1]) == 0.0      # +inf padding is neutral
    if vec:
        assert float(ds[-1]) == 0.0


@pytest.mark.parametrize("vec", [False, True])
def test_fused_kernels_ragged_and_unaligned(dev, vec):
    # N not a multiple of anything, from one float into its storage, and
    # a single particle.
    v, e, s, g = _vec_inputs(dev, n=70_001, n_edges=41)
    v, s = v[1:], (s[1:] if vec else s[0].clone())
    _fused_case(v, e, s, g, 33)
    _fused_case(v[:1].clone(), e, s[:1].clone() if vec else s, g, 33)


@pytest.mark.parametrize("vec", [False, True])
def test_fused_counts_match_dense(dev, vec):
    v, e, s, g = _vec_inputs(dev, n_edges=41)
    s = (s if vec else s[0].clone()).requires_grad_()
    v.requires_grad_()
    e.requires_grad_()
    before = (fk.fused_counts_fwd_cuda.launches,
              fk.fused_counts_bwd_cuda.launches)
    window = tb.fused_bin_window(e, 0.32)
    fused = binned_erf_counts(v, e, s, bin_mode="fused", bin_window=window)
    dense = binned_erf_counts(v, e, s)
    np.testing.assert_allclose(fused.detach().cpu().numpy(),
                               dense.detach().cpu().numpy(), rtol=1e-5,
                               atol=1e-4)
    gf = torch.autograd.grad((fused * g).sum(), (v, e, s))
    gd = torch.autograd.grad((dense * g).sum(), (v, e, s))
    for a, b in zip(gf, gd):
        _assert_close(a, b)
    assert (fk.fused_counts_fwd_cuda.launches,
            fk.fused_counts_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    # The whole fused path repeats bit for bit.
    again = binned_erf_counts(v, e, s, bin_mode="fused", bin_window=window)
    assert torch.equal(fused, again)
    for a, b in zip(gf, torch.autograd.grad((again * g).sum(), (v, e, s))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_history_model_on_card_matches_cpu(dev, mode):
    kwargs = {} if mode == "dense" else dict(
        bin_edges=np.linspace(7.0, 11.75, 41),
        obs_indices=(5, 7, 9, 11, 13, 15), bin_mode="fused",
        sigma_max=0.32)
    # chip_smoke.py's phase 9, with its references and limits: the CPU
    # model fed the card's mean log M* at the tolerances of
    # tests/test_galhalo_hist.py:110-118; the whole CPU model at those too
    # (dense), or at loss rtol 2e-3 and gradient rtol 8e-3 (41 edges, six
    # epochs: the history's own card-versus-CPU rounding, twice the worst
    # gap of the dense path there, tools/hist_card_vs_cpu.py).
    gpu = GalhaloHistModel(aux_data=make_galhalo_hist_data(
        1_000_000, chunk_size=250_000, device=dev, **kwargs))
    cpu = GalhaloHistModel(aux_data={
        k: (x.cpu() if isinstance(x, torch.Tensor) else x)
        for k, x in gpu.aux_data.items()})
    params = np.array(HIST_TRUTH, np.float32) + 0.05
    card = evaluate(gpu, params)
    for ref, (y_rtol, loss_rtol, grad_rtol) in (
            (evaluate_fed(cpu, gpu.aux_data, params), (1e-4, 1e-3, 1e-3)),
            (evaluate(cpu, params), (1e-4, 1e-3, 1e-3) if mode == "dense"
             else (1e-4, 2e-3, 8e-3))):
        np.testing.assert_allclose(card[0], ref[0], rtol=y_rtol, atol=1e-10)
        np.testing.assert_allclose(card[1], ref[1], rtol=loss_rtol)
        np.testing.assert_allclose(card[2], ref[2], rtol=grad_rtol,
                                   atol=1e-7)
    assert float(gpu.calc_loss_from_params(list(HIST_TRUTH))) < 1e-10


# --------------------------------------------------------------------------
# The history's chunk (csrc/hist_history.cu)
# --------------------------------------------------------------------------
def _hist_inputs(dev, n_times, n=100_003, n_pad=3, seed=3):
    """A ragged chunk of ``n`` halos whose last ``n_pad`` are the pad
    sentinel, a time grid of ``n_times`` steps and parameters off TRUTH."""
    lm = gh.sample_log_halo_masses(n - n_pad, device=dev)
    lm = torch.cat([lm, torch.full((n_pad,), gh._PAD_LOGM, device=dev)])
    rng = np.random.default_rng(seed)
    params = np.array(HIST_TRUTH) + 0.05 * rng.standard_normal(10)
    return (lm, torch.tensor(params, dtype=torch.float32, device=dev),
            gh.default_time_grid(n_times, device=dev))


def _history_and_grad(block, lm, params, t_grid, obs, g):
    p = params.clone().requires_grad_(True)
    out = block(lm, p, t_grid, obs)
    (grad,) = torch.autograd.grad((out * g).sum(), p)
    return out.detach(), grad


# (T, epochs): the model's grid and epochs, and grids of 24 and 64 steps
# (the kernels' other register caps) with the first and last epochs.
@pytest.mark.parametrize("n_times,obs", [
    (16, (7, 12, 15)), (16, (1, 5, 9, 15)), (24, (1, 4, 4, 17, 23)),
    (64, (1, 32, 63))])
def test_history_kernels_match_twin(dev, n_times, obs):
    # The kernels against their plain version on the card.  Mean log M*
    # (5 to 12 dex) within 2e-5 dex, about 20 float32 ulps: the two take
    # the same steps, but the card's PyTorch divides by a constant as a
    # product with its reciprocal and sums the scan in float32 where the
    # kernel sums in double, as the CPU does, and their expf, log10f and
    # powf may round apart by an ulp or two; pad halos give the sentinel
    # exactly.  The gradient at the other kernels' rtol 1e-3 (sums over
    # 1e5 halos in another order).
    lm, params, t_grid = _hist_inputs(dev, n_times)
    g = torch.tensor(np.random.default_rng(4).standard_normal(
        (lm.shape[0], len(obs))), dtype=torch.float32, device=dev)
    got, grad = _history_and_grad(gh._mean_log_mstar_block, lm, params,
                                  t_grid, obs, g)
    want, grad_want = _history_and_grad(gh._mean_log_mstar_torch, lm,
                                        params, t_grid, obs, g)
    pad = lm > 100.0
    assert bool((got[pad] == gh._PAD_OUT).all())
    np.testing.assert_allclose(got[~pad].cpu().numpy(),
                               want[~pad].cpu().numpy(), rtol=0, atol=2e-5)
    _assert_close(grad, grad_want)
    assert float(grad[8]) == float(grad[9]) == 0.0


def test_history_kernels_repeat_and_count(dev):
    # One launch a call each way, the same bits on repeat; the backward
    # reads its cotangent at any strides.
    lm, params, t_grid = _hist_inputs(dev, 16)
    obs = (7, 12, 15)
    before = hk.history_fwd_cuda.launches, hk.history_bwd_cuda.launches
    out = hk.history_fwd_cuda(lm, params, t_grid, obs)
    assert torch.equal(out, hk.history_fwd_cuda(lm, params, t_grid, obs))
    g = torch.linspace(-1.0, 1.0, lm.shape[0] * 3, device=dev).reshape(
        lm.shape[0], 3)
    grad = hk.history_bwd_cuda(lm, params, t_grid, obs, g.t())
    assert torch.equal(grad, hk.history_bwd_cuda(lm, params, t_grid, obs,
                                                 g.t()))
    assert torch.equal(grad, hk.history_bwd_cuda(lm, params, t_grid, obs,
                                                 g.t().contiguous()))
    assert (hk.history_fwd_cuda.launches, hk.history_bwd_cuda.launches) == \
        (before[0] + 2, before[1] + 3)
    with pytest.raises(ValueError, match="float32"):
        hk.history_fwd_cuda(lm, params.double(), t_grid, obs)
    with pytest.raises(ValueError, match="epochs"):
        hk.history_fwd_cuda(lm, params, gh.default_time_grid(65, device=dev),
                            obs)


def test_history_long_grid_is_refused(dev):
    # The card runs only the kernels: a grid beyond their registers is
    # refused, not sent to the plain version, and nothing launches.
    lm, params, _ = _hist_inputs(dev, 16, n=1_000)
    t_grid = gh.default_time_grid(hk.MAX_TIMES + 1, device=dev)
    before = hk.history_fwd_cuda.launches
    with pytest.raises(ValueError, match="time steps"):
        gh.mean_log_mstar(lm, params, t_grid, obs_indices=(5, 64))
    assert hk.history_fwd_cuda.launches == before


def test_history_params_off_the_card(dev):
    # Parameters as a CPU or float64 tensor, or a tuple, with halos on the
    # card: cast once onto the card, the same result and gradient as the
    # float32 tensor there.  Halo masses that need a gradient raise in
    # the backward: the kernels differentiate the parameters only.
    lm, params, t_grid = _hist_inputs(dev, 16, n=1_003)
    obs = (7, 12, 15)

    def public(lm, p, t_grid, obs):
        return gh.mean_log_mstar(lm, p, t_grid, obs_indices=obs)
    want, grad_want = _history_and_grad(public, lm, params, t_grid, obs, 1.0)
    for other in (params.cpu(), params.double(), params.cpu().double()):
        got, grad = _history_and_grad(public, lm, other, t_grid, obs, 1.0)
        assert torch.equal(got, want)
        assert torch.equal(grad.to(dev, torch.float32), grad_want)
    assert torch.equal(gh.mean_log_mstar(lm, tuple(params.tolist()), t_grid,
                                         obs_indices=obs), want)
    masses = lm.clone().requires_grad_(True)
    out = gh.mean_log_mstar(masses, params, t_grid, obs_indices=obs)
    with pytest.raises(RuntimeError, match="parameters only"):
        out.sum().backward()


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_history_model_kernels_against_twin(dev, mode, monkeypatch):
    # The whole model on the card with the history kernels against the same
    # model with the plain history, at phase 9's limits against the CPU
    # (the history rounded two ways), with a ragged last chunk.
    kwargs = {} if mode == "dense" else dict(
        bin_edges=np.linspace(7.0, 11.75, 41),
        obs_indices=(5, 7, 9, 11, 13, 15), bin_mode="fused",
        sigma_max=0.32)
    model = GalhaloHistModel(aux_data=make_galhalo_hist_data(
        300_007, chunk_size=100_000, device=dev, **kwargs))
    params = np.array(HIST_TRUTH, np.float32) + 0.05
    card = evaluate(model, params)
    monkeypatch.setattr(gh, "_mean_log_mstar_block", gh._mean_log_mstar_torch)
    twin = evaluate(model, params)
    y_rtol, loss_rtol, grad_rtol = (1e-4, 1e-3, 1e-3) if mode == "dense" \
        else (1e-4, 2e-3, 8e-3)
    np.testing.assert_allclose(card[0], twin[0], rtol=y_rtol, atol=1e-10)
    np.testing.assert_allclose(card[1], twin[1], rtol=loss_rtol)
    np.testing.assert_allclose(card[2], twin[2], rtol=grad_rtol, atol=1e-7)


def test_history_batched_rows_equal_solo_and_repeat(dev):
    # The one-launch kernels' rule: a K-batched row equals its solo call,
    # and a call repeats, bit for bit.
    model = GalhaloHistModel(aux_data=make_galhalo_hist_data(
        200_003, chunk_size=50_000, device=dev))
    rows = torch.tensor(np.array(HIST_TRUTH, np.float32)[None, :]
                        + np.float32([[0.05], [-0.03], [0.02]]),
                        device=dev)
    losses, grads = model.batched_loss_and_grad_fn()(rows,
                                                     model.aux_leaves())
    for k in range(rows.shape[0]):
        loss, grad = model.calc_loss_and_grad_from_params(rows[k])
        again = model.calc_loss_and_grad_from_params(rows[k])
        assert torch.equal(loss, losses[k]) and torch.equal(grad, grads[k])
        assert torch.equal(loss, again[0]) and torch.equal(grad, again[1])


def test_history_launches_a_chunked_step(dev):
    # One loss and gradient over 100 chunks: 200 forward launches (the
    # pass and the checkpoint's recompute) and 100 backward, none of the
    # plain history on the card, and each epoch's erf kernels as before.
    model = GalhaloHistModel(aux_data=make_galhalo_hist_data(
        100_000, chunk_size=1_000, device=dev))
    torch.cuda.synchronize()
    launches = _launch_counts()
    model.calc_loss_and_grad_from_params(np.array(HIST_TRUTH) + 0.05)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_launch_counts(), launches)]
    assert moved == [0, 0, 600, 300, 0, 0, 0, 0, 0, 200, 100]


# --------------------------------------------------------------------------
# Pair counts (csrc/pair_counts.cu)
# --------------------------------------------------------------------------
def _pair_inputs(dev, n, box, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    return torch.tensor(pos, device=dev), torch.tensor(w, device=dev)


# name: (n1, n2 (None: autocorrelation), box, pimax, edges)
PAIR_CASES = {
    "projected_box": (20_003, None, 250.0, 20.0, np.logspace(-0.5, 1.2, 9)),
    "3d_box": (20_003, None, 75.0, None, np.logspace(-0.3, 1.1, 8)),
    "3d_no_box": (20_003, None, None, None, np.logspace(-0.3, 1.1, 8)),
    "asymmetric": (9_001, 14_999, 100.0, 20.0, np.logspace(-0.5, 1.2, 9)),
    "edge_at_zero": (20_003, None, 75.0, None, np.array([0.0, 1.0, 4.0])),
}


@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_pair_kernels_match_plain(dev, name):
    # Counts and row sums within rtol 1e-4 of the plain version (the same
    # masks, float32 sums of up to N^2 products in another order);
    # gradients rtol 1e-3, atol 1e-5 max|grad|, as chip_smoke.py phase 12.
    from multigrad_tpu_torch.ops import pair_kernels as pk
    n1, n2, box, pimax, edges = PAIR_CASES[name]
    p1, w1 = _pair_inputs(dev, n1, box or 100.0, 1)
    p2, w2 = (p1, w1) if n2 is None else _pair_inputs(dev, n2,
                                                      box or 100.0, 2)
    esq = torch.tensor(edges, dtype=torch.float32, device=dev) ** 2
    g = torch.linspace(-1.0, 2.0, esq.shape[0] - 1, device=dev)
    got, rows = pk.pair_counts_fwd_cuda(p1, w1, p2, w2, esq, box, pimax,
                                        rows=True)
    want, rows_plain = pk.pair_counts_fwd_plain(p1, w1, p2, w2, esq, box,
                                                pimax, rows=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4)
    _assert_close(rows, rows_plain, rtol=1e-4)
    assert torch.equal(got, pk.pair_counts_fwd_cuda(p1, w1, p2, w2, esq,
                                                    box, pimax))
    dw1, dw2 = pk.pair_counts_bwd_plain(p1, w1, p2, w2, esq, g, box, pimax,
                                        autocorr=n2 is None)
    _assert_close(pk.pair_rowgrad_cuda(rows, g), dw1)
    _assert_close(pk.pair_counts_bwd_cuda(p1, p2, w2, esq, g, box, pimax),
                  dw1)
    if n2 is not None:
        _assert_close(pk.pair_counts_bwd_cuda(p2, p1, w1, esq, g, box,
                                              pimax), dw2)
    if edges[0] == 0.0:
        # The self pairs sit in the first bin: Σ w² of them.
        assert float(got[0]) >= float((w1 * w1).sum())


@pytest.mark.parametrize("box", [250.0, 77.7])
def test_pair_rows_with_unit_weights_equal_plain(dev, box):
    # Integer row sums below 2^24: equal only if every mask agrees.
    from multigrad_tpu_torch.ops import pair_kernels as pk
    p, _ = _pair_inputs(dev, 20_003, box, 5)
    ones = torch.ones(p.shape[0], device=dev)
    esq = torch.tensor(np.logspace(-0.5, 1.2, 9), dtype=torch.float32,
                       device=dev) ** 2
    _, rows = pk.pair_counts_fwd_cuda(p, ones, p, ones, esq, box, 20.0,
                                      rows=True)
    _, rows_plain = pk.pair_counts_fwd_plain(p, ones, p, ones, esq, box,
                                             20.0, rows=True)
    assert float(rows.sum()) > 0
    assert torch.equal(rows, rows_plain)


def test_pair_positions_outside_the_box(dev):
    # Positions outside [0, box] take the kernels' division branch.
    from multigrad_tpu_torch.ops import pair_kernels as pk
    rng = np.random.default_rng(6)
    pos = torch.tensor(rng.uniform(-60.0, 160.0, size=(20_003, 3))
                       .astype(np.float32), device=dev)
    w = torch.tensor(rng.uniform(0.2, 1.0, size=20_003).astype(np.float32),
                     device=dev)
    esq = torch.tensor(np.logspace(-0.3, 1.1, 8), dtype=torch.float32,
                       device=dev) ** 2
    got = pk.pair_counts_fwd_cuda(pos, w, pos, w, esq, 100.0, None)
    want = pk.pair_counts_fwd_plain(pos, w, pos, w, esq, 100.0, None)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4)


def test_pair_counts_autograd_launches(dev):
    # An autocorrelation's backward reads the forward's row sums (one
    # pair_rowgrad launch, no sweep); a cross-correlation's sweeps the pairs
    # once more, for dw2.
    from multigrad_tpu_torch.ops import pair_kernels as pk
    p1, w1 = _pair_inputs(dev, 5_000, 100.0, 3)
    p2, w2 = _pair_inputs(dev, 4_000, 100.0, 4)
    edges = torch.tensor(np.logspace(-0.5, 1.2, 9), dtype=torch.float32,
                         device=dev)
    wrappers = (pk.pair_counts_fwd_cuda, pk.pair_rowgrad_cuda,
                pk.pair_counts_bwd_cuda)
    for autocorr, n_sweeps in ((True, 0), (False, 1)):
        a = w1.clone().requires_grad_()
        b = a if autocorr else w2.clone().requires_grad_()
        before = [fn.launches for fn in wrappers]
        counts = pk.pair_counts(p1, a, p1 if autocorr else p2, b, edges,
                                box_size=100.0, pimax=20.0)
        counts.sum().backward()
        torch.cuda.synchronize()
        assert [fn.launches - n for fn, n in zip(wrappers, before)] == [
            1, 1, n_sweeps]
        assert torch.isfinite(a.grad).all()


def test_wprp_loss_at_truth_on_card(dev):
    from multigrad_tpu_torch.models import WprpModel, make_wprp_data
    from multigrad_tpu_torch.models.wprp import TRUTH
    model = WprpModel(aux_data=make_wprp_data(8192, box_size=100.0,
                                              device=dev))
    assert float(model.calc_loss_from_params(TRUTH)) < 1e-10


# The joint SMF + wp(rp) group on the card (small size): its launches are
# those of the two solo paths added together, it agrees with the same group
# on the CPU at the wp(rp) limits (loss and gradient rtol 1e-3, atol
# 1e-5·max|grad|), and a checkpointed fit equals the plain one bit for bit.
JOINT_POINT = (-1.8, 0.3, -0.7)


def _joint_on(device, like=None):
    """The joint group at 8,192 + 32,768 halos; with ``like``, the same
    data moved to ``device``."""
    from multigrad_tpu_torch.models import make_joint_smf_wprp
    from multigrad_tpu_torch.models.joint import _joint_group
    if like is None:
        return make_joint_smf_wprp(num_halos=8_192, smf_num_halos=32_768,
                                   device=device)
    return _joint_group(*({k: (v.to(device) if torch.is_tensor(v) else v)
                           for k, v in m.aux_data.items()}
                          for m in like.models))


def test_joint_group_launches(dev):
    from multigrad_tpu_torch.ops import pair_kernels as pk
    group = _joint_on(dev)
    wrappers = {"erf_fwd": ek.erf_counts_fwd_cuda,
                "erf_bwd": ek.erf_counts_bwd_cuda,
                "pair_fwd": pk.pair_counts_fwd_cuda,
                "pair_rowgrad": pk.pair_rowgrad_cuda,
                "pair_bwd": pk.pair_counts_bwd_cuda}
    before = {k: fn.launches for k, fn in wrappers.items()}
    group.run_adam(guess=JOINT_POINT, nsteps=3, learning_rate=0.02,
                   progress=False)
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k] for k, fn in wrappers.items()} == {
        "erf_fwd": 3, "erf_bwd": 3, "pair_fwd": 3, "pair_rowgrad": 3,
        "pair_bwd": 0}


def test_joint_group_on_card_matches_cpu(dev):
    group = _joint_on(dev)
    cpu = _joint_on("cpu", like=group)
    loss_g, grad_g = group.calc_loss_and_grad_from_params(JOINT_POINT)
    loss_c, grad_c = cpu.calc_loss_and_grad_from_params(JOINT_POINT)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-3)
    _assert_close(grad_g, grad_c)
    # Each member alone too, the wp(rp) one at its own scale.
    for card_m, cpu_m in zip(group.models, cpu.models):
        _assert_close(card_m.calc_loss_and_grad_from_params(JOINT_POINT)[1],
                      cpu_m.calc_loss_and_grad_from_params(JOINT_POINT)[1])


def test_joint_checkpointed_fit_equals_plain(dev, tmp_path):
    group = _joint_on(dev)
    kwargs = dict(guess=JOINT_POINT, nsteps=10, learning_rate=0.02,
                  progress=False)
    plain = group.run_adam(**kwargs)
    ckpted = group.run_adam(checkpoint_dir=str(tmp_path), checkpoint_every=4,
                            **kwargs)
    assert torch.equal(ckpted, plain)
    assert torch.equal(group.run_adam(checkpoint_dir=str(tmp_path),
                                      checkpoint_every=4, **kwargs), plain)


# The streamed SMF path: 200,003 halos (a ragged tail) in chunks of 65,536.
STREAM_HALOS, STREAM_CHUNK = 200_003, 65_536


def test_prefetcher_on_card(dev):
    from multigrad_tpu_torch.data import (ArraySource, ChunkPrefetcher,
                                          plan_chunks)
    from multigrad_tpu_torch.utils.profiling import StreamStats
    rng = np.random.default_rng(3)
    src = ArraySource(rng.normal(size=STREAM_HALOS).astype(np.float32))
    plan = plan_chunks(STREAM_HALOS, STREAM_CHUNK)
    stats = StreamStats()
    pf = ChunkPrefetcher(lambda k: src._chunk_rows(plan.chunks[k]),
                         plan.n_chunks, device=dev, stats=stats)
    seen = []
    for k, chunk in pf:
        assert chunk.device.type == "cuda"
        # The consumer's own stream reads it after the copy.
        host = chunk.cpu().numpy()
        np.testing.assert_array_equal(host, src.load_chunk(plan.chunks[k]))
        seen.append(k)
        # Pinned staging: (like, pinned tensors, views, device buffers).
        assert all(slot is None or slot[1][0].is_pinned()
                   for slot in pf._staging.slots)
    assert seen == list(range(plan.n_chunks))
    assert stats.max_live_buffers <= 2
    assert stats.chunks == plan.n_chunks


def test_streamed_matches_resident_on_card(dev):
    from multigrad_tpu_torch.data import StreamingOnePointModel
    resident = SMFModel(aux_data=make_smf_data(STREAM_HALOS, device=dev))
    aux = make_smf_data(STREAM_HALOS, device=dev)
    log_mh = aux.pop("log_halo_masses").cpu().numpy()
    params = (-1.7, 0.35)
    loss_r, grad_r = resident.calc_loss_and_grad_from_params(params)
    results = {}
    for prefetch in (True, False):
        sm = StreamingOnePointModel(model=SMFModel(aux_data=aux),
                                    streams={"log_halo_masses": log_mh},
                                    chunk_rows=STREAM_CHUNK,
                                    prefetch=prefetch)
        results[prefetch] = sm.calc_loss_and_grad_from_params(params)
        assert sm.last_stats.max_live_buffers <= 2
        assert sm.last_stats.chunks == 2 * sm.plan().n_chunks
    # The staging's buffers are made once and serve every pass.
    first = sm._staging.slots[0][3][0].data_ptr()
    sm.calc_loss_and_grad_from_params(params)
    assert sm._staging.slots[0][3][0].data_ptr() == first
    scan = sm.calc_loss_and_grad_scan(params)
    for other in (results[False], scan):
        assert all(torch.equal(a, b) for a, b in zip(results[True], other))
    loss_s, grad_s = results[True]
    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(grad_s.cpu().numpy(), grad_r.cpu().numpy(),
                               rtol=1e-4,
                               atol=1e-6 * float(grad_r.abs().max()))


def _launch_counts():
    from multigrad_tpu_torch.ops import pair_kernels as pk
    return [fn.launches for fn in (
        ek.erf_counts_fwd_cuda, ek.erf_counts_bwd_cuda,
        ek.erf_counts_fwd_vec_cuda, ek.erf_counts_bwd_vec_cuda,
        fk.fused_counts_fwd_cuda, fk.fused_counts_bwd_cuda,
        pk.pair_counts_fwd_cuda, pk.pair_rowgrad_cuda,
        pk.pair_counts_bwd_cuda, hk.history_fwd_cuda, hk.history_bwd_cuda)]


def test_model_cost_on_card_runs_nothing(dev):
    # The static cost model of a model on the card launches no kernel and
    # takes no memory there; the kernels' counts are the SMF's N·E.
    from multigrad_tpu_torch.telemetry.costmodel import model_cost
    n = 1_000_000
    smf = SMFModel(aux_data=make_smf_data(n, device=dev))
    hist = GalhaloHistModel(aux_data=make_galhalo_hist_data(
        200_000, chunk_size=100_000, device=dev))
    torch.cuda.synchronize()
    launches = _launch_counts()
    allocations = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    cost = model_cost(smf, (-1.0, 0.5))
    hist_cost = model_cost(hist, np.asarray(HIST_TRUTH))
    torch.cuda.synchronize()
    assert _launch_counts() == launches
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == \
        allocations
    assert cost.transcendentals["erf"] == cost.transcendentals["exp"] \
        == n * 11
    assert hist_cost.flops_by_prim["erf_counts_fwd_vec"] > 0


def test_tune_model_on_card_then_warm(dev, tmp_path):
    from multigrad_tpu_torch.tune import TuningTable, tune_model
    table = TuningTable(str(tmp_path / "t.json"))
    model = SMFModel(aux_data=make_smf_data(1_000_000, device=dev))
    res = tune_model(model, (-1.0, 0.5), sigma_max=0.6, table=table,
                     reps=1, trial="eval")
    assert not res.warm and res.n_trials == 2
    assert "|cuda|" in res.key
    for c in res.candidates:
        assert 0 < c["roofline_frac"] <= 1.05, c
    launches = _launch_counts()
    again = tune_model(model, (-1.0, 0.5), sigma_max=0.6, table=table)
    assert again.warm and again.n_trials == 0
    assert _launch_counts() == launches
