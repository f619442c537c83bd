"""The port's weighted pair counts against the JAX package's.

The plain PyTorch versions of the pair-count CUDA kernels (what a CPU
tensor runs, through ``PairCounts``) are held against
``multigrad_tpu.ops.pairwise._block_counts`` (the XLA path) and the Pallas
kernel ``pair_counts_pallas`` in interpret mode (``tile=128`` or ``256``),
on the same numpy inputs, forward and weight gradients, as
``tests/test_pallas.py:227-268`` runs them: projected, 3D with and without
a box, asymmetric and ragged blocks.  Tolerance rtol 1e-4 (with an atol of
1e-6 of the largest gradient, for weights with no neighbour in any bin):
the bin masks are the same, and the float32 sums run in another order.
The ring, the self-pair exclusion and the row chunks are held against the
brute-force counts of ``tests/test_pairwise.py:27-69`` at rtol 1e-5.  The
CUDA kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py``, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.ops import pairwise as jp
from multigrad_tpu.ops.pallas_kernels import pair_counts_pallas
from multigrad_tpu_torch.ops import pairwise as tp
from multigrad_tpu_torch.ops.pair_kernels import (MAX_BINS, PairCounts,
                                                  pair_counts,
                                                  pair_counts_bwd_plain,
                                                  pair_counts_fwd_plain)

BOX = 50.0
EDGES = np.geomspace(0.5, 15, 9).astype(np.float32)

# name: (n1, n2 (None: autocorrelation), box, pimax, edges, Pallas tile)
CASES = {
    "projected": (500, None, BOX, 10.0, EDGES, 256),
    "3d_box": (500, None, BOX, None, EDGES, 256),
    "3d_no_box": (400, None, None, None, EDGES, 128),
    "asymmetric": (300, 450, None, None, EDGES[::2], 128),
    "ragged_projected": (333, 211, BOX, 12.0, EDGES, 128),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # The suite's workers share the machine's cores with JAX's own thread
    # pools: keep PyTorch's intra-op pool small while this module runs.
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _points(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box or BOX, size=(n, 3)).astype(np.float32)
    return pos, rng.uniform(0.2, 1.0, size=n).astype(np.float32)


def _case(name):
    n1, n2, box, pimax, edges, tile = CASES[name]
    pos1, w1 = _points(n1, box, seed=1)
    pos2, w2 = (pos1, w1) if n2 is None else _points(n2, box, seed=2)
    return pos1, w1, pos2, w2, edges, box, pimax, tile


def _port_counts(pos1, w1, pos2, w2, edges, box, pimax):
    """Counts and the two weight tensors (one for an autocorrelation)."""
    t1 = torch.tensor(pos1)
    tw1 = torch.tensor(w1, requires_grad=True)
    if pos2 is pos1:
        t2, tw2 = t1, tw1
    else:
        t2, tw2 = torch.tensor(pos2), torch.tensor(w2, requires_grad=True)
    return pair_counts(t1, tw1, t2, tw2, torch.tensor(edges), box_size=box,
                       pimax=pimax), tw1, tw2


def _jax_fns(pos1, pos2, edges, box, pimax, tile):
    """The JAX package's counts as functions of (w1, w2): the XLA path and
    the Pallas kernel in interpret mode."""
    p1, p2, e = jnp.asarray(pos1), jnp.asarray(pos2), jnp.asarray(edges)
    auto = pos2 is pos1
    return {
        "xla": lambda a, b: jp._block_counts(p1, a, p1 if auto else p2,
                                             a if auto else b, e * e, box,
                                             pimax),
        "pallas": lambda a, b: pair_counts_pallas(
            p1, a, p1 if auto else p2, a if auto else b, e, box_size=box,
            pimax=pimax, tile=tile, interpret=True),
    }


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    pos1, w1, pos2, w2, edges, box, pimax, tile = _case(name)
    got, _, _ = _port_counts(pos1, w1, pos2, w2, edges, box, pimax)
    assert got.shape == (edges.shape[0] - 1,)
    for ref, fn in _jax_fns(pos1, pos2, edges, box, pimax, tile).items():
        want = np.asarray(fn(jnp.asarray(w1), jnp.asarray(w2)))
        assert np.all(want > 0), (ref, want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   err_msg=ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_weight_gradients_match_jax(name):
    pos1, w1, pos2, w2, edges, box, pimax, tile = _case(name)
    cot = np.arange(1.0, edges.shape[0], dtype=np.float32)
    counts, tw1, tw2 = _port_counts(pos1, w1, pos2, w2, edges, box, pimax)
    (counts * torch.tensor(cot)).sum().backward()
    auto = pos2 is pos1
    for ref, fn in _jax_fns(pos1, pos2, edges, box, pimax, tile).items():
        if auto:
            want = (jax.grad(lambda a: jnp.sum(fn(a, a) * cot))(
                jnp.asarray(w1)),)
            got = (tw1.grad,)
        else:
            want = jax.grad(lambda a, b: jnp.sum(fn(a, b) * cot),
                            argnums=(0, 1))(jnp.asarray(w1), jnp.asarray(w2))
            got = (tw1.grad, tw2.grad)
        for g, r in zip(got, want):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                       atol=1e-6 * np.abs(r).max(),
                                       err_msg=ref)


@pytest.mark.parametrize("autocorr", [True, False])
def test_analytic_backward_matches_autograd(autocorr):
    # PairCounts' analytic backward (the kernels' algebra, G·w2 and w1·G)
    # against autograd through the plain counts (pairwise._block_counts).
    pos1, w1 = _points(400, BOX, seed=3)
    pos2, w2 = (pos1, w1) if autocorr else _points(250, BOX, seed=4)
    cot = torch.linspace(-1.0, 2.0, 8)
    grads = []
    for fn in ("kernel", "autograd"):
        a = torch.tensor(w1, requires_grad=True)
        b = a if autocorr else torch.tensor(w2, requires_grad=True)
        p1 = torch.tensor(pos1)
        p2 = p1 if autocorr else torch.tensor(pos2)
        if fn == "kernel":
            counts = pair_counts(p1, a, p2, b, torch.tensor(EDGES),
                                 box_size=BOX, pimax=15.0)
        else:
            counts = tp._block_counts(p1, a, p2, b, torch.tensor(EDGES) ** 2,
                                      BOX, 15.0)
        grads.append((counts.detach(),) + torch.autograd.grad(
            (counts * cot).sum(), (a,) if autocorr else (a, b)))
    for x, y in zip(*grads):
        # The same float32 terms, summed in another order.
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(y.abs().max()))


def test_plain_versions_agree_with_each_other():
    pos, w = _points(300, BOX, seed=5)
    p, tw = torch.tensor(pos), torch.tensor(w)
    esq = torch.tensor(EDGES) ** 2
    g = torch.linspace(0.5, 3.0, 8)
    # Row blocks (ragged, of 64) change nothing but the order of the sums.
    whole = pair_counts_fwd_plain(p, tw, p, tw, esq, BOX, None, row_chunk=None)
    ragged = pair_counts_fwd_plain(p, tw, p, tw, esq, BOX, None, row_chunk=64)
    np.testing.assert_allclose(ragged.numpy(), whole.numpy(), rtol=1e-6)
    dw1, dw2 = pair_counts_bwd_plain(p, tw, p, tw, esq, g, BOX, None, 64,
                                     autocorr=False)
    auto1, auto2 = pair_counts_bwd_plain(p, tw, p, tw, esq, g, BOX, None, 64,
                                         autocorr=True)
    assert auto2 is auto1
    # G is symmetric: the column sweep equals the row sweep.
    np.testing.assert_allclose(dw2.numpy(), dw1.numpy(), rtol=1e-5,
                               atol=1e-6 * float(dw1.abs().max()))
    np.testing.assert_allclose(auto1.numpy(), dw1.numpy(), rtol=0, atol=0)


def test_zero_weight_padding_is_neutral():
    pos1, w1 = _points(300, BOX, seed=6)
    pos2, w2 = _points(200, BOX, seed=7)
    pad_pos = np.zeros((17, 3), np.float32)
    pad_w = np.zeros(17, np.float32)
    edges = torch.tensor(EDGES)
    results = []
    for p1, a, p2, b in ((pos1, w1, pos2, w2),
                         (np.concatenate([pos1, pad_pos]),
                          np.concatenate([w1, pad_w]),
                          np.concatenate([pos2, pad_pos]),
                          np.concatenate([w2, pad_w]))):
        ta = torch.tensor(a, requires_grad=True)
        tb = torch.tensor(b, requires_grad=True)
        counts = pair_counts(torch.tensor(p1), ta, torch.tensor(p2), tb,
                             edges, box_size=BOX, pimax=10.0)
        counts.sum().backward()
        results.append((counts.detach(), ta.grad, tb.grad))
    (c0, a0, b0), (c1, a1, b1) = results
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(a1[:300].numpy(), a0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(b1[:200].numpy(), b0.numpy(), rtol=1e-6)
    assert torch.isfinite(a1).all() and torch.isfinite(b1).all()


def test_bins_above_the_cap_raise():
    pos, w = _points(64, BOX, seed=8)
    many = np.linspace(0.1, 20, MAX_BINS + 2).astype(np.float32)
    with pytest.raises(ValueError, match=f"at most {MAX_BINS} bins"):
        pair_counts(torch.tensor(pos), torch.tensor(w), torch.tensor(pos),
                    torch.tensor(w), torch.tensor(many))
    with pytest.raises(ValueError, match=f"at most {MAX_BINS} bins"):
        pair_counts_pallas(jnp.asarray(pos), jnp.asarray(w), jnp.asarray(pos),
                           jnp.asarray(w), jnp.asarray(many))
    # At the cap itself the counts run.
    at_cap = torch.tensor(many[:-1])
    counts = pair_counts(torch.tensor(pos), torch.tensor(w),
                         torch.tensor(pos), torch.tensor(w), at_cap)
    assert counts.shape == (MAX_BINS,) and torch.isfinite(counts).all()


def test_pair_counts_function_takes_weights_only():
    pos, w = _points(50, BOX, seed=9)
    p = torch.tensor(pos, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    esq = torch.tensor(EDGES) ** 2
    counts = PairCounts.apply(p, tw, p, tw, esq, BOX, None, True, None)
    counts.sum().backward()
    assert p.grad is None and torch.isfinite(tw.grad).all()


# --------------------------------------------------------------------------
# The ring (one block), against brute force
# --------------------------------------------------------------------------
def _brute_force_counts(pos, w, edges, box=None, pimax=None):
    """O(N²) numpy reference: ordered weighted pair counts, no self pairs
    (tests/test_pairwise.py:27-45)."""
    pos, w, edges = (np.asarray(x, np.float64) for x in (pos, w, edges))
    diff = pos[:, None, :] - pos[None, :, :]
    if box is not None:
        diff = diff - box * np.round(diff / box)
    if pimax is None:
        sep = np.sqrt((diff ** 2).sum(-1))
        ok = np.ones(sep.shape, dtype=bool)
    else:
        sep = np.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)
        ok = np.abs(diff[..., 2]) < pimax
    ok &= ~np.eye(len(pos), dtype=bool)
    wprod = np.outer(w, w)
    return np.array([(wprod * (ok & (sep >= edges[b])
                                & (sep < edges[b + 1]))).sum()
                     for b in range(len(edges) - 1)])


@pytest.fixture(scope="module")
def mock():
    from multigrad_tpu_torch.models import (WprpParams, make_galaxy_mock,
                                            selection_weights)
    pos, logm = make_galaxy_mock(512, 60.0, seed=1, device="cpu")
    return pos, selection_weights(logm, WprpParams())


@pytest.mark.parametrize("pimax, edges", [(None, [0.5, 2.0, 5.0, 10.0]),
                                          (15.0, [0.3, 1.0, 3.0, 8.0])])
@pytest.mark.parametrize("row_chunk", [None, 100])
def test_ring_counts_match_brute_force(mock, pimax, edges, row_chunk):
    pos, w = mock
    got = tp.ring_weighted_pair_counts(pos, w, torch.tensor(edges),
                                       box_size=60.0, pimax=pimax,
                                       row_chunk=row_chunk)
    want = _brute_force_counts(pos.numpy(), w.numpy(), edges, 60.0, pimax)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_self_pair_exclusion_zero_edge(mock):
    pos, w = mock
    edges = torch.tensor([0.0, 1.0, 4.0])
    incl = tp.ring_weighted_pair_counts(pos, w, edges, box_size=60.0,
                                        exclude_self=False)
    excl = tp.ring_weighted_pair_counts(pos, w, edges, box_size=60.0)
    np.testing.assert_allclose((incl - excl).numpy(),
                               [float((w * w).sum()), 0.0], rtol=1e-6)
    np.testing.assert_allclose(
        excl.numpy(), _brute_force_counts(pos.numpy(), w.numpy(),
                                          edges.numpy(), 60.0), rtol=1e-5)
    # The JAX package's exclusion on the same inputs.
    want = jp.ring_weighted_pair_counts(jnp.asarray(pos.numpy()),
                                        jnp.asarray(w.numpy()),
                                        jnp.asarray(edges.numpy()),
                                        box_size=60.0)
    np.testing.assert_allclose(excl.numpy(), np.asarray(want), rtol=1e-4)


def test_rr_wp_xi_match_jax():
    edges = np.logspace(-0.5, 1.2, 9).astype(np.float32)
    dd = np.random.default_rng(10).uniform(1e3, 1e5, 8).astype(np.float32)
    for pimax in (None, 20.0):
        np.testing.assert_allclose(
            tp.analytic_rr_counts(123.5, torch.tensor(edges), 1e6,
                                  pimax=pimax).numpy(),
            np.asarray(jp.analytic_rr_counts(123.5, jnp.asarray(edges), 1e6,
                                             pimax=pimax)), rtol=1e-6)
    np.testing.assert_allclose(
        tp.wp_from_counts(torch.tensor(dd), 400.0, torch.tensor(edges), 20.0,
                          1e6).numpy(),
        np.asarray(jp.wp_from_counts(jnp.asarray(dd), 400.0,
                                     jnp.asarray(edges), 20.0, 1e6)),
        rtol=1e-5)
    np.testing.assert_allclose(
        tp.xi_from_counts(torch.tensor(dd), 400.0, torch.tensor(edges),
                          1e6).numpy(),
        np.asarray(jp.xi_from_counts(jnp.asarray(dd), 400.0,
                                     jnp.asarray(edges), 1e6)), rtol=1e-5)
    rr = tp.analytic_rr_counts(10.0, torch.tensor([0.0, 1.0]), 1000.0)
    np.testing.assert_allclose(rr.numpy(), 100.0 * 4 * np.pi / 3 / 1000.0,
                               rtol=1e-6)
