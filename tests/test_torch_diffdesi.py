"""The port's halo-catalog index utilities (``utils/diffdesi.py``) against
the JAX package's: the cases of ``tests/test_utils.py:28-58`` on the
port's copies of the NumPy functions, and the torch fixpoint against
``find_ultimate_top_indices_jax`` on seeded random forests (exact: both
are integer gathers)."""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch.utils import diffdesi


def test_find_ultimate_top_indices():
    # chains 3 -> 1 -> 0 -> 0 resolve to 0
    idx = np.array([0, 0, 1, 1, 3])
    out = diffdesi.find_ultimate_top_indices(idx)
    np.testing.assert_array_equal(out, [0, 0, 0, 0, 0])
    out_t, converged = diffdesi.find_ultimate_top_indices_torch(
        torch.as_tensor(idx))
    np.testing.assert_array_equal(out_t.numpy(), out)
    assert converged.dtype == torch.bool and bool(converged)


def test_find_ultimate_top_indices_cycle():
    # A 3-cycle oscillates under index-squaring and never resolves (a
    # 2-cycle squares to the identity, which is a fixpoint): NumPy
    # raises, the torch loop reports converged=False.
    cyc = np.array([1, 2, 0])
    with pytest.raises(RecursionError):
        diffdesi.find_ultimate_top_indices(cyc)
    _, converged = diffdesi.find_ultimate_top_indices_torch(
        torch.as_tensor(cyc))
    assert not bool(converged)


def test_sort_and_reindex_consistency():
    idx = np.array([2, 2, 0, 2, 4, 4])
    sorted_arrays, reindexed = diffdesi.sort_all_by_ultimate_top_dump(
        idx, arrays_to_sort=[np.arange(6.0)],
        arrays_to_sort_and_reindex=[idx])
    assert len(sorted_arrays) == 1 and len(reindexed) == 1
    assert sorted_arrays[0].shape == (6,)


def _forest(rng, n, roots):
    """Each halo points at a host of lower index, or at itself (a root)."""
    idx = np.arange(n)
    for i in range(n):
        if i >= roots:
            idx[i] = rng.integers(0, i)
    perm = rng.permutation(n)
    inverse = np.argsort(perm)
    return inverse[idx[perm]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_copies_and_torch_fixpoint_match_jax(seed):
    import jax.numpy as jnp
    from multigrad_tpu.utils import diffdesi as jax_diffdesi
    rng = np.random.default_rng(seed)
    idx = _forest(rng, 2_000, roots=1 + seed * 10)
    want = jax_diffdesi.find_ultimate_top_indices(idx)
    np.testing.assert_array_equal(
        diffdesi.find_ultimate_top_indices(idx), want)
    want_jax, want_conv = jax_diffdesi.find_ultimate_top_indices_jax(
        jnp.asarray(idx))
    got, converged = diffdesi.find_ultimate_top_indices_torch(
        torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jax))
    assert bool(converged) == bool(want_conv)
    values = rng.normal(size=idx.size)
    got_sorted, got_reindexed = diffdesi.sort_all_by_ultimate_top_dump(
        idx, [values], [idx])
    want_sorted, want_reindexed = jax_diffdesi.sort_all_by_ultimate_top_dump(
        idx, [values], [idx])
    np.testing.assert_array_equal(got_sorted[0], want_sorted[0])
    np.testing.assert_array_equal(got_reindexed[0], want_reindexed[0])
    np.testing.assert_array_equal(diffdesi.sort_and_reindex(idx),
                                  jax_diffdesi.sort_and_reindex(idx))
    assert diffdesi.MAX_RECURSION == jax_diffdesi.MAX_RECURSION


def test_torch_fixpoint_stays_on_its_device():
    idx = torch.tensor([0, 0, 1, 2, 3, 4])
    out, converged = diffdesi.find_ultimate_top_indices_torch(idx)
    assert out.device == idx.device and converged.device == idx.device
    assert out.tolist() == [0] * 6
