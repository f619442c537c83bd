"""The port's one-launch fused counts (``FusedCounts``) against the JAX
package, and the window start as the CUDA kernel finds it.

On the CPU ``FusedCounts`` runs its plain versions
(``fused_counts_fwd_plain``, ``fused_counts_bwd_plain``), the same
functions ``chip_smoke.py`` holds the kernels of ``csrc/fused_counts.cu``
against on the card.  They are held here against the Pallas kernel
``binned_erf_counts_fused_pallas`` in interpret mode (``block_size=1024``),
on the same numpy inputs, with a scalar and a per-particle sigma, at the
tolerances of ``tests/test_torch_fused.py``: counts ``rtol=2e-5,
atol=1e-5`` (float32 sums in another order), gradients ``rtol=1e-3,
atol=1e-5``.

The kernel finds each window's start itself, by a binary search over the
edges in shared memory; ``kernel_starts`` below emulates it operation for
operation in numpy float32 (``x = v - fl(5.656854 * sigma)`` rounded
without FMA contraction, then an upper bound by the predicate
``!(x < e)``), and it must give ``window_starts``' starts exactly, on
values chosen to land on ``edge + half`` and its neighbouring floats,
±inf, NaN and both clips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.ops.pallas_kernels import binned_erf_counts_fused_pallas
from multigrad_tpu_torch.ops import binned as tb
from multigrad_tpu_torch.ops import fused_kernels as fk

EDGES = np.linspace(7.0, 11.75, 41).astype(np.float32)   # the history's
WINDOW = 33
RNG_SEED = 23
HALF_Z = np.float32(5.656854249492381)   # kHalfZ in csrc/fused_counts.cu


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.tensor(np.asarray(x))


def _inputs(n, vec, sigma_max=0.32, seed=RNG_SEED, n_inf=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(9.4, 0.9, size=n).astype(np.float32)
    if n_inf:
        vals[-n_inf:] = np.inf
    sig = (rng.uniform(0.05, sigma_max, size=n).astype(np.float32) if vec
           else np.float32(0.25))
    cot = rng.normal(size=EDGES.shape[0] - 1).astype(np.float32)
    return vals, sig, cot


def _pallas(window):
    return lambda v, e, s: binned_erf_counts_fused_pallas(
        v, e, s, window, block_size=1024, interpret=True)


# --------------------------------------------------------------------------
# FusedCounts (plain) against the Pallas kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("window", [12, WINDOW])
def test_fused_counts_plain_match_jax(vec, window):
    vals, sig, _ = _inputs(3000, vec, n_inf=9)
    want = _pallas(window)(jnp.asarray(vals), jnp.asarray(EDGES),
                           jnp.asarray(sig))
    got = fk.FusedCounts.apply(_t(vals), _t(EDGES), _t(sig), window)
    direct = fk.fused_counts_fwd_plain(_t(vals), _t(EDGES), _t(sig), window)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("window", [12, WINDOW])
def test_fused_counts_gradients_match_jax(vec, window):
    # All three gradients, the edges' included, through FusedCounts'
    # analytic backward (fused_counts_bwd_plain).  At W = 12 the window
    # cuts the Gaussians of the wider sigmas, so the window-local h
    # decides the gradients at the window's ends.
    vals, sig, cot = _inputs(3000, vec, n_inf=9)
    fn = _pallas(window)
    want = jax.grad(lambda v, e, s: jnp.sum(fn(v, e, s) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(vals), jnp.asarray(EDGES),
                                       jnp.asarray(sig))
    v, e = _t(vals).requires_grad_(), _t(EDGES).requires_grad_()
    s = _t(sig).requires_grad_()
    (fk.FusedCounts.apply(v, e, s, window) * _t(cot)).sum().backward()
    for ref, got in zip(want, (v.grad, e.grad, s.grad)):
        assert tuple(got.shape) == np.shape(ref)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3,
                                   atol=1e-5)
    np.testing.assert_array_equal(v.grad[-9:].numpy(), 0.0)


@pytest.mark.parametrize("vec", [False, True])
def test_bwd_plain_without_edges(vec):
    # The main path's backward (the edges need no gradient): the same dv
    # and dsigma, bit for bit, and no dedges.
    vals, sig, cot = _inputs(2000, vec)
    args = (_t(vals), _t(EDGES), _t(sig), WINDOW, _t(cot))
    dv, de, ds = fk.fused_counts_bwd_plain(*args)
    dv2, de2, ds2 = fk.fused_counts_bwd_plain(*args, need_dedges=True)
    assert de is None and tuple(de2.shape) == EDGES.shape
    np.testing.assert_array_equal(dv.numpy(), dv2.numpy())
    np.testing.assert_array_equal(ds.numpy(), ds2.numpy())
    assert tuple(ds.shape) == np.shape(sig)


@pytest.mark.parametrize("vec", [False, True])
def test_fused_masses_match_jax_core(vec):
    # The masses-level building blocks (fused_masses_fwd_plain and
    # fused_masses_bwd_plain, slot-major) against the Pallas kernel behind
    # _fused_masses_core: the (N, W-1) masses, and the gradients in the
    # values, sigma and the window's edges, and JAX's per-slot edge
    # cotangent added onto the edges it read against the port's scatter
    # of it (window_rows and slot_diagonal_sum).
    from multigrad_tpu.ops.pallas_kernels import _fused_masses_core
    vals, sig, _ = _inputs(2000, vec, n_inf=5)
    start = tb.window_starts(torch.clamp(_t(vals), -1e18, 1e18), _t(EDGES),
                             _t(sig), WINDOW).numpy()
    offs = start[:, None] + np.arange(WINDOW)
    cot = np.random.default_rng(5).normal(
        size=(vals.shape[0], WINDOW - 1)).astype(np.float32)

    def core(v, ewin, s):
        return _fused_masses_core(1024, True, WINDOW, v, ewin, s)

    ewin = jnp.asarray(EDGES[offs])
    want = core(jnp.asarray(vals), ewin, jnp.asarray(sig))
    gv, gw, gs = jax.grad(lambda v, w, s: jnp.sum(core(v, w, s) * cot),
                          argnums=(0, 1, 2))(jnp.asarray(vals), ewin,
                                             jnp.asarray(sig))
    ge = np.zeros(EDGES.shape, np.float64)
    np.add.at(ge, offs, np.asarray(gw, np.float64))
    v, e, s, st = _t(vals), _t(EDGES), _t(sig), _t(start)
    got = fk.fused_masses_fwd_plain(v, e, s, st, WINDOW).t()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-6)
    dv, dewin, ds = fk.fused_masses_bwd_plain(
        v, e, s, st, WINDOW, _t(cot).t().contiguous(), need_dewin=True)
    np.testing.assert_allclose(dewin.t().numpy(), np.asarray(gw),
                               rtol=1e-3, atol=1e-5)
    de = tb.slot_diagonal_sum(tb.window_rows(dewin, st, EDGES.shape[0]),
                              EDGES.shape[0])
    for ref, g in ((gv, dv), (ge, de), (gs, ds.reshape(np.shape(sig)))):
        assert tuple(g.shape) == np.shape(ref)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-3,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# The window-local h at the window's ends
# --------------------------------------------------------------------------
def _window_local_dv(vals, sig, edges, cot, window, h_kind):
    """dJ/dv in float64 from the window's start (window_starts), with
    ``h_w = gm[w-1] - gm[w]`` over the window (``gm[-1] = gm[W-1] = 0``,
    the kernel's) or over the whole count vector (``g[s-1] - g[s]``,
    the dense path's)."""
    start = tb.window_starts(_t(vals), _t(edges), _t(sig), window).numpy()
    e = edges.astype(np.float64)
    g = np.concatenate([[0.0], cot.astype(np.float64), [0.0]])  # g[-1..E-1]
    dv = np.zeros(vals.shape[0])
    inv = 1.0 / (np.sqrt(2.0) * np.broadcast_to(sig, vals.shape))
    for w in range(window):
        idx = start + w
        z = (e[idx] - vals) * inv
        if h_kind == "window":
            left = np.where(w > 0, g[idx], 0.0)              # gm[w-1]
            right = np.where(w < window - 1, g[idx + 1], 0.0)
        else:
            left, right = g[idx], g[idx + 1]
        dv += (left - right) * np.exp(-z * z)
    return -(inv / np.sqrt(np.pi)) * dv


@pytest.mark.parametrize("vec", [False, True])
def test_window_local_h_at_the_ends(vec):
    # A window of 6 edges around Gaussians of sigma up to 0.32 (spacing
    # 0.119): the ends' P = exp(-z^2) are far from 0, so the window-local
    # h and the dense path's differ, and the plain backward follows the
    # window-local one.
    window = 6
    vals, sig, cot = _inputs(500, vec)
    vals = vals.clip(8.0, 10.5)
    dv, _, _ = fk.fused_counts_bwd_plain(_t(vals), _t(EDGES), _t(sig),
                                         window, _t(cot))
    local = _window_local_dv(vals, sig, EDGES, cot, window, "window")
    dense = _window_local_dv(vals, sig, EDGES, cot, window, "dense")
    scale = np.abs(local).max()
    np.testing.assert_allclose(dv.numpy(), local, rtol=1e-4,
                               atol=1e-6 * scale)
    assert np.abs(local - dense).max() > 1e-2 * scale


# --------------------------------------------------------------------------
# The window start as the kernel finds it
# --------------------------------------------------------------------------
def kernel_starts(vals, edges, sig, window):
    """``window_start`` of csrc/fused_counts.cu, operation for operation:
    the clip to ±1e18, ``x = v - fl(HALF_Z * sigma)`` in float32, the
    branch-free upper bound by ``!(x < e)`` and the clip to ``[0, E-W]``."""
    vals = np.clip(np.asarray(vals, np.float32), np.float32(-1e18),
                   np.float32(1e18))
    sig = np.broadcast_to(np.asarray(sig, np.float32), vals.shape)
    with np.errstate(invalid="ignore"):
        x = vals - (HALF_Z * sig)
    assert x.dtype == np.float32
    n_edges = edges.shape[0]
    base = np.zeros(vals.shape, np.int64)
    length = n_edges
    while length > 1:
        half = length >> 1
        base = np.where(~(x < edges[base + half]), base + half, base)
        length -= half
    count = base + np.where(x < edges[base], 0, 1)
    return np.clip(count - 1, 0, n_edges - window)


def _adversarial(edges, sig):
    """Values whose x = v - half lies on an edge, or one float from it,
    for every edge (half as the kernel rounds it), and beyond the ends."""
    sig = np.float32(sig)
    half = HALF_Z * sig
    vals = []
    for e in edges:
        v = np.float32(e + half)
        for _ in range(3):
            v = np.nextafter(v, np.float32(-np.inf))
        for _ in range(7):
            vals.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    vals += [np.inf, -np.inf, np.nan, np.float32(1e18), np.float32(-1e18),
             np.float32(3e38), edges[0] - 10, edges[-1] + 10,
             edges[0], edges[-1]]
    return np.array(vals, np.float32)


@pytest.mark.parametrize("n_edges, window", [
    (2, 2), (41, 2), (41, WINDOW), (41, 41), (300, 128), (16_384, 33)])
@pytest.mark.parametrize("vec", [False, True])
def test_kernel_start_equals_window_starts(n_edges, window, vec):
    edges = np.linspace(7.0, 11.75, n_edges).astype(np.float32)
    if n_edges > 2_000:     # keep the window test's arrays small
        edges_test = edges[::64]
        vals = _adversarial(edges_test, 0.25)
    else:
        vals = _adversarial(edges, 0.25)
    rng = np.random.default_rng(n_edges)
    vals = np.concatenate([vals, rng.normal(9.4, 1.5, 2000).astype(
        np.float32)])
    sig = (np.full(vals.shape, 0.25, np.float32) if vec
           else np.float32(0.25))
    if vec:   # other widths on the random half
        sig[-2000:] = rng.uniform(0.01, 0.4, 2000).astype(np.float32)
    clipped = torch.clamp(_t(vals), -1e18, 1e18)
    want = tb.window_starts(clipped, _t(edges), _t(sig), window)
    got = kernel_starts(vals, edges, sig, window)
    np.testing.assert_array_equal(got, want.numpy())
    # Both clips and an interior start are exercised.
    assert got.min() == 0 and got.max() == n_edges - window
    if n_edges - window > 1:
        assert ((got > 0) & (got < n_edges - window)).any()


def test_kernel_start_lands_on_edges():
    # Where x = v - half is exactly an edge, the start is that edge
    # (searchsorted's right=True), one float below it the edge before.
    sig = np.float32(0.25)
    half = HALF_Z * sig
    hits = 0
    for k, e in enumerate(EDGES[1:-1], start=1):
        v = np.float32(e + half)
        for dv in range(-4, 5):
            u = v
            step = np.float32(np.inf) if dv > 0 else np.float32(-np.inf)
            for _ in range(abs(dv)):
                u = np.nextafter(u, step)
            x = np.float32(u - half)
            got = kernel_starts(np.array([u]), EDGES, sig, 2)[0]
            if x == e:
                hits += 1
                assert got == k
            elif x < e:
                assert got == k - 1
            else:
                assert got >= k
    assert hits > 0


# --------------------------------------------------------------------------
# The CUDA wrappers' argument checks (before any launch)
# --------------------------------------------------------------------------
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    vals, sig, cot = _inputs(64, True)
    v, e, s = _t(vals), _t(EDGES), _t(sig)
    with pytest.raises(ValueError, match="window must be in"):
        fk.fused_counts_fwd_cuda(v, e, s, 42)
    with pytest.raises(ValueError, match="window must be in"):
        fk.fused_counts_fwd_cuda(v, e, s, 1)
    with pytest.raises(ValueError, match="bin edges"):
        fk.fused_counts_fwd_cuda(v, torch.linspace(0, 1, 16_385), s, 33)
    with pytest.raises(ValueError, match="float32"):
        fk.fused_counts_fwd_cuda(v.double(), e, s, 33)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_counts_fwd_cuda(torch.stack([v, v], 1)[:, 0], e, s, 33)
    with pytest.raises(ValueError, match="sigma"):
        fk.fused_counts_fwd_cuda(v, e, s[:10], 33)
    with pytest.raises(ValueError, match="dcounts must have shape"):
        fk.fused_counts_bwd_cuda(v, e, s, 33, _t(cot[:-1]))


def test_fused_grid_rule():
    # Both fused kernels' grid (ops/fused_kernels.py::fused_grid), by the
    # rule of every one-launch kernel (cuda_build.one_launch_grid): a block
    # per 4,096 particles or more, as many blocks on every SM, at most 16
    # an SM, and rows of n_edges + 1 partials that the workspace holds,
    # with or without dedges.
    from multigrad_tpu_torch.ops import cuda_build
    per = cuda_build.PER_BLOCK * 132
    assert fk.fused_grid(1, 132, 41) == 132
    assert fk.fused_grid(per, 132, 41) == 132
    assert fk.fused_grid(per + 1, 132, 41) == 264
    assert fk.fused_grid(1_000_000, 132, 41) == 264
    assert fk.fused_grid(100_000_000, 132, 41) == 132 * 16
    assert fk.fused_grid(100_000_000, 132, fk.MAX_FUSED_EDGES) == \
        cuda_build.PARTIALS // (fk.MAX_FUSED_EDGES + 1)
