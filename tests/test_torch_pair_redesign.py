"""The pair-count kernels' division-free minimum image and their split
backward, on the CPU.

The CUDA kernels decide the minimum image's ``round(d / box)`` by comparing
``|d|`` with :func:`min_image_threshold` when both positions lie in
``[0, box]``, and divide otherwise.  A plain-PyTorch emulation of that
decision is held, bit for bit, against numpy's IEEE float32 division on the
floats where it could go wrong (within 1000 ulp of ``box/2`` and of
``box``), on ±0, ±box and on random positions.

The forward's per-row bin sums ``R`` (``pair_counts_fwd_plain(...,
rows=True)``) give the counts as ``w1 · R_b`` and the row-side gradient as
``g @ R`` (:func:`pair_rowgrad_plain`), which is held against the pair
sweep's ``dw1`` (:func:`pair_counts_bwd_plain`) at rtol 1e-5, atol 1e-6 of
the largest gradient: the same float32 terms, summed in another order.
With unit weights ``R`` holds integers below 2^24 and is exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multigrad_tpu_torch.ops.pair_kernels import (_pair_metrics,
                                                  min_image_threshold,
                                                  pair_counts,
                                                  pair_counts_bwd_plain,
                                                  pair_counts_fwd_plain,
                                                  pair_rowgrad_plain)

BOXES = [250.0, 100.0, 75.0, 77.7, 1000.0]
EDGES = np.geomspace(0.5, 15, 9).astype(np.float32)
ULPS = 1000


def _ulp_neighbours(x):
    """Every float32 within ULPS ulp of float32 x > 0, both signs."""
    bits = np.float32(x).view(np.int32) + np.arange(-ULPS, ULPS + 1,
                                                    dtype=np.int32)
    near = bits.view(np.float32)
    return np.concatenate([near, -near])


def _ieee_round(d, box):
    """rint(fl(d / box)) in numpy float32 (IEEE division, half to even)."""
    return np.rint(d / np.float32(box))


def _kernel_k(d, thr):
    """The kernels' k for |d| <= box, in plain PyTorch."""
    d = torch.from_numpy(d)
    return torch.where(d.abs() >= thr, torch.copysign(torch.ones_like(d), d),
                       torch.zeros_like(d)).numpy()


def _kernel_min_image(xi, xj, box, thr):
    """The kernels' minimum image of xi - xj, in plain PyTorch: the
    comparison with thr when both positions lie in [0, box], the IEEE
    division (numpy float32) otherwise."""
    xi, xj = torch.from_numpy(xi), torch.from_numpy(xj)
    d = xi - xj
    near = ((xi >= 0) & (xi <= box)) & ((xj >= 0) & (xj <= box))
    by_thr = torch.where(d.abs() >= thr,
                         d - torch.copysign(torch.full_like(d, box), d), d)
    dn = d.numpy()
    far = torch.from_numpy(dn - np.float32(box) * _ieee_round(dn, box))
    return torch.where(near, by_thr, far).numpy(), near.numpy(), dn


@pytest.mark.parametrize("box", BOXES)
def test_min_image_threshold_is_the_least(box):
    b = np.float32(box)
    thr = np.float32(min_image_threshold(box))
    below = np.nextafter(thr, np.float32(0.0))
    assert thr / b > np.float32(0.5)
    assert not below / b > np.float32(0.5)
    # A quotient of exactly 0.5 rounds to 0: the threshold is above box/2.
    assert thr > b / np.float32(2.0)


@pytest.mark.parametrize("box", BOXES)
def test_kernel_k_matches_ieee_division(box):
    b = np.float32(box)
    thr = min_image_threshold(box)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, box, size=(2, 20_000)).astype(np.float32)
    d = np.concatenate([_ulp_neighbours(b / np.float32(2.0)),
                        _ulp_neighbours(b),
                        np.array([0.0, -0.0, b, -b, thr, -thr], np.float32),
                        pos[0] - pos[1]]).astype(np.float32)
    d = d[np.abs(d) <= b]
    k = _kernel_k(d, thr)
    want = _ieee_round(d, box)
    assert set(np.unique(want)) == {-1.0, 0.0, 1.0}
    # Equal as values; a zero k's sign is d's in the division, which the
    # kernels never form (they select d itself).
    np.testing.assert_array_equal(k, want)


@pytest.mark.parametrize("box", BOXES)
def test_kernel_min_image_matches_division(box):
    b = np.float32(box)
    thr = min_image_threshold(box)
    rng = np.random.default_rng(1)
    inside = rng.uniform(0, box, size=(2, 20_000)).astype(np.float32)
    # Pairs on the adversarial differences: xj = 0 or xj = box.
    adv = np.concatenate([_ulp_neighbours(b / np.float32(2.0)),
                          _ulp_neighbours(b)])
    adv = adv[np.abs(adv) <= b]
    xi_adv = np.where(adv >= 0, adv, adv + b).astype(np.float32)
    xj_adv = np.where(adv >= 0, 0.0, b).astype(np.float32)
    # Positions outside [0, box], which take the division.
    outside = rng.uniform(-box, 2 * box, size=(2, 20_000)).astype(np.float32)
    xi = np.concatenate([inside[0], xi_adv, outside[0],
                         np.float32([0.0, b, -0.0, 0.0])])
    xj = np.concatenate([inside[1], xj_adv, outside[1],
                         np.float32([b, 0.0, 0.0, -0.0])])
    got, near, d = _kernel_min_image(xi, xj, box, thr)
    want = d - b * _ieee_round(d, box)
    assert near.sum() > 20_000 and (~near).sum() > 10_000
    assert np.all(np.abs(d[near]) <= b)
    # Far pairs exist that the comparison alone would get wrong.
    assert np.any(np.abs(d[~near]) > b)
    # Equal as values (the sign of a zero aside), and the squares, which
    # are all that sep² and the pi cut use, bit for bit.
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((got * got).view(np.int32),
                                  (want * want).view(np.int32))


@pytest.mark.parametrize("box", [0.0, -5.0, np.inf, np.nan])
def test_min_image_threshold_rejects_a_bad_box(box):
    with pytest.raises(ValueError, match="positive and finite"):
        min_image_threshold(box)


# --------------------------------------------------------------------------
# The row sums R and the row-side gradient
# --------------------------------------------------------------------------
def _points(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box or 50.0, size=(n, 3)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    return torch.tensor(pos), torch.tensor(w)


# name: (n1, n2 (None: autocorrelation), box, pimax, row_chunk)
GEOMETRIES = {
    "projected_box": (400, None, 50.0, 10.0, None),
    "3d_box": (400, None, 50.0, None, 96),
    "3d_no_box": (300, None, None, None, None),
    "cross_projected_box": (333, 211, 50.0, 12.0, 64),
    "cross_3d_box": (250, 300, 50.0, None, None),
    "cross_3d_no_box": (280, 190, None, None, 100),
}


def _geometry(name):
    n1, n2, box, pimax, row_chunk = GEOMETRIES[name]
    p1, w1 = _points(n1, box, seed=11)
    p2, w2 = (p1, w1) if n2 is None else _points(n2, box, seed=12)
    return p1, w1, p2, w2, box, pimax, row_chunk


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_rows_dot_w1_equal_the_counts(name):
    p1, w1, p2, w2, box, pimax, row_chunk = _geometry(name)
    esq = torch.tensor(EDGES) ** 2
    counts, rows = pair_counts_fwd_plain(p1, w1, p2, w2, esq, box, pimax,
                                         row_chunk, rows=True)
    assert rows.shape == (EDGES.shape[0] - 1, p1.shape[0])
    assert torch.equal(counts, pair_counts_fwd_plain(p1, w1, p2, w2, esq, box,
                                                     pimax, row_chunk))
    assert float(counts.sum()) > 0
    np.testing.assert_allclose((rows @ w1).numpy(), counts.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_rowgrad_matches_the_sweep(name):
    p1, w1, p2, w2, box, pimax, row_chunk = _geometry(name)
    esq = torch.tensor(EDGES) ** 2
    g = torch.linspace(-1.0, 2.0, EDGES.shape[0] - 1)
    _, rows = pair_counts_fwd_plain(p1, w1, p2, w2, esq, box, pimax,
                                    row_chunk, rows=True)
    dw1, _ = pair_counts_bwd_plain(p1, w1, p2, w2, esq, g, box, pimax,
                                   row_chunk, autocorr=p2 is p1)
    got = pair_rowgrad_plain(rows, g)
    assert got.shape == dw1.shape
    np.testing.assert_allclose(got.numpy(), dw1.numpy(), rtol=1e-5,
                               atol=1e-6 * float(dw1.abs().max()))


@pytest.mark.parametrize("pimax", [None, 10.0])
def test_unit_weight_rows_are_exact(pimax):
    p, _ = _points(400, 50.0, seed=13)
    ones = torch.ones(p.shape[0])
    _, rows = pair_counts_fwd_plain(p, ones, p, ones,
                                    torch.tensor(EDGES) ** 2, 50.0, pimax,
                                    row_chunk=128, rows=True)
    # Integer counts of the same float32 masks.
    sep2, pi_abs = _pair_metrics(p, p, 50.0, pimax is not None)
    ok = torch.ones_like(sep2, dtype=torch.bool) if pimax is None \
        else pi_abs < pimax
    esq = torch.tensor(EDGES) ** 2
    want = torch.stack([(ok & (sep2 >= esq[b]) & (sep2 < esq[b + 1]))
                        .sum(1) for b in range(len(EDGES) - 1)])
    assert float(want.max()) < 2 ** 24 and float(want.sum()) > 0
    assert torch.equal(rows, torch.round(rows))
    assert torch.equal(rows.long(), want)


@pytest.mark.parametrize("side", ["w1", "w2"])
def test_gradient_of_one_side_of_a_cross_correlation(side):
    p1, w1, p2, w2, box, pimax, _ = _geometry("cross_projected_box")
    edges = torch.tensor(EDGES)
    cot = torch.linspace(0.5, 2.0, EDGES.shape[0] - 1)
    both = [w1.clone().requires_grad_(), w2.clone().requires_grad_()]
    (pair_counts(p1, both[0], p2, both[1], edges, box, pimax) * cot).sum() \
        .backward()
    one = [w1.clone(), w2.clone()]
    k = 0 if side == "w1" else 1
    one[k].requires_grad_()
    counts = pair_counts(p1, one[0], p2, one[1], edges, box, pimax)
    # The row sums are kept only when w1 needs its gradient.
    rows = counts.grad_fn.saved_tensors[-1]
    assert (rows is not None) == (side == "w1")
    (counts * cot).sum().backward()
    assert one[1 - k].grad is None
    np.testing.assert_allclose(one[k].grad.numpy(), both[k].grad.numpy(),
                               rtol=0, atol=0)


def test_ab_tool_needs_a_card():
    # tools/pair_kernels_ab.py measures on the card only: without one it
    # exits non-zero and prints no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/pair_kernels_ab.py",
                          "old.cu"], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and out.stdout == ""
