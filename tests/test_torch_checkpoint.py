"""Checkpointed Adam and ``utils.checkpoint``: the port's counterparts of
``tests/test_checkpoint_resume.py``.

A fit with ``checkpoint_dir`` runs the same host loop in segments, so it
equals the plain fit bit for bit (``torch.equal``), also after a simulated
preemption (an exception raised from the loss after some step) and a
resume; a finished fit is a pure read (the loss is not called).  A resume
with another configuration, another state structure or other data raises.
``save`` / ``load`` keep the JAX package's archive layout, so an archive
of one structure reads in either package; the JAX-parity test of the
trajectory holds the port's checkpointed SMF fit to the JAX package's at
``tests/test_torch_smf.py``'s Adam limit (atol 1e-4).
"""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import (ParamTuple, SMFModel,
                                        aux_from_numpy, make_smf_data)
from multigrad_tpu_torch.optim import adam as tadam
from multigrad_tpu_torch.utils import checkpoint as ckpt

CPU = "cpu"
GUESS = ParamTuple(-1.0, 0.5)
BOUNDS = [(-3.0, 0.0), (0.01, 1.0)]


@pytest.fixture
def model():
    return SMFModel(aux_data=make_smf_data(4_000, device=CPU))


class _Counted(SMFModel):
    """An SMF model that counts its loss evaluations and can raise from
    one (a preemption mid-fit)."""
    calls = 0
    fail_at = None

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        type(self).calls += 1
        if type(self).calls == type(self).fail_at:
            raise RuntimeError("simulated preemption")
        return super().calc_partial_sumstats_from_params(params)


def _fit(model, tmp_path=None, **kwargs):
    args = dict(guess=GUESS, nsteps=12, learning_rate=0.02, progress=False)
    args.update(kwargs)
    if tmp_path is not None:
        args["checkpoint_dir"] = str(tmp_path)
    return model.run_adam(**args)


@pytest.mark.parametrize("every", [1, 5, 12, None])
def test_checkpointed_fit_matches_plain(model, tmp_path, every):
    plain = _fit(model)
    ckpted = _fit(model, tmp_path, checkpoint_every=every)
    assert torch.equal(ckpted, plain)
    assert (tmp_path / "adam_state.npz").exists()
    assert not (tmp_path / "adam_state.npz.tmp.npz").exists()


def test_resume_after_simulated_preemption(tmp_path):
    data = make_smf_data(4_000, device=CPU)
    plain = _fit(SMFModel(aux_data=data))
    # The loss raises at its 10th call, in step 10: steps 1-8 are in the
    # checkpoint (segments of 4), step 9 is lost.
    _Counted.calls, _Counted.fail_at = 0, 10
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _fit(_Counted(aux_data=data), tmp_path, checkpoint_every=4)
    saved = np.load(tmp_path / "adam_state.npz")
    assert int(saved["leaf_6"]) == 8      # "step", sorted after the rest
    _Counted.calls, _Counted.fail_at = 0, None
    resumed = _fit(_Counted(aux_data=data), tmp_path, checkpoint_every=4)
    assert _Counted.calls == 12 - 8
    assert torch.equal(resumed, plain)
    # A finished fit is a pure read: no evaluation, the same trajectory.
    _Counted.calls = 0
    again = _fit(_Counted(aux_data=data), tmp_path, checkpoint_every=4)
    assert _Counted.calls == 0
    assert torch.equal(again, resumed)


def test_checkpointed_fit_with_bounds_and_key(model, tmp_path):
    kwargs = dict(nsteps=10, param_bounds=BOUNDS, randkey=7)
    plain = _fit(model, **kwargs)
    ckpted = _fit(model, tmp_path, checkpoint_every=3, **kwargs)
    assert torch.equal(ckpted, plain)
    again = _fit(model, tmp_path, checkpoint_every=3, **kwargs)
    assert torch.equal(again, plain)
    const = dict(kwargs, const_randkey=True)
    assert torch.equal(_fit(model, tmp_path / "c", checkpoint_every=4,
                            **const), _fit(model, **const))


def test_config_mismatch_rejected(model, tmp_path):
    _fit(model, tmp_path, nsteps=6)
    with pytest.raises(ValueError, match="different nsteps"):
        _fit(model, tmp_path, nsteps=9)
    for other in (dict(guess=ParamTuple(-1.5, 0.3)),
                  dict(learning_rate=0.05), dict(randkey=1),
                  dict(param_bounds=BOUNDS)):
        with pytest.raises(ValueError, match="different fit configuration"):
            _fit(model, tmp_path, nsteps=6, **other)
    _fit(model, tmp_path / "key", nsteps=6, randkey=1)
    with pytest.raises(ValueError, match="different fit configuration"):
        _fit(model, tmp_path / "key", nsteps=6, randkey=2)


def test_structure_mismatch_rejected(model, tmp_path):
    _fit(model, tmp_path, nsteps=6)
    ckpt.save(str(tmp_path / "adam_state"), {"bogus": np.zeros(3)})
    with pytest.raises(ValueError, match="cannot resume") as excinfo:
        _fit(model, tmp_path, nsteps=6)
    assert str(tmp_path) in str(excinfo.value)
    assert "different state structure" in str(excinfo.value)


def test_data_change_rejected(model, tmp_path):
    _fit(model, tmp_path, nsteps=6)
    masses = model.aux_data["log_halo_masses"]
    edited = masses.clone()
    edited[17] = torch.nextafter(edited[17], torch.tensor(np.inf))
    for changed in (masses * 1.01, edited, torch.roll(masses, 1)):
        other = SMFModel(aux_data=dict(model.aux_data,
                                       log_halo_masses=changed))
        with pytest.raises(ValueError, match="different training data"):
            _fit(other, tmp_path, nsteps=6)
    volume = SMFModel(aux_data=dict(model.aux_data, volume=1.0))
    with pytest.raises(ValueError, match="different training data"):
        _fit(volume, tmp_path, nsteps=6)


def test_finished_bounded_fit_is_stored_as_returned(model, tmp_path,
                                                    monkeypatch):
    # The last write holds the bounded trajectory the fit returned, so
    # the read of a finished bounded fit maps nothing through the
    # bijection, either way: on the card it launches no kernel.
    kwargs = dict(nsteps=6, param_bounds=BOUNDS)
    ckpted = _fit(model, tmp_path, checkpoint_every=4, **kwargs)
    saved = np.load(tmp_path / "adam_state.npz")
    assert int(saved["leaf_6"]) == 6      # "step"
    np.testing.assert_array_equal(saved["leaf_7"], ckpted.numpy())  # "traj"

    def no_transform(*args, **kwargs):
        raise AssertionError("the read ran the bounds' transform")

    for name in ("check_strictly_inside", "transform_array",
                 "inverse_transform_array"):
        monkeypatch.setattr(tadam, name, no_transform)
    assert torch.equal(_fit(model, tmp_path, checkpoint_every=4, **kwargs),
                       ckpted)


def test_bounded_resume_after_simulated_preemption(tmp_path):
    # Mid-fit segments hold the unbounded rows: a bounded fit resumed
    # after a preemption equals the plain bounded fit bit for bit.
    data = make_smf_data(4_000, device=CPU)
    kwargs = dict(nsteps=10, param_bounds=BOUNDS, randkey=3)
    plain = _fit(SMFModel(aux_data=data), **kwargs)
    _Counted.calls, _Counted.fail_at = 0, 8
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _fit(_Counted(aux_data=data), tmp_path, checkpoint_every=3, **kwargs)
    assert int(np.load(tmp_path / "adam_state.npz")["leaf_6"]) == 6
    _Counted.calls, _Counted.fail_at = 0, None
    resumed = _fit(_Counted(aux_data=data), tmp_path, checkpoint_every=3,
                   **kwargs)
    assert _Counted.calls == 10 - 6
    assert torch.equal(resumed, plain)


def test_fingerprint_sees_one_ulp_and_order():
    a = torch.full((1000,), 1.0)
    b = a.clone()
    b[17] = torch.nextafter(b[17], torch.tensor(2.0))
    assert tadam._args_fingerprint({"x": a}) != tadam._args_fingerprint(
        {"x": b})
    assert tadam._args_fingerprint([a, b]) != tadam._args_fingerprint([b, a])
    assert tadam._args_fingerprint({"x": a}) == tadam._args_fingerprint(
        {"x": a.clone()})
    i, j = torch.tensor([2 ** 33]), torch.tensor([2 ** 34])
    assert tadam._args_fingerprint(i) != tadam._args_fingerprint(j)


def test_save_load_round_trip(tmp_path):
    tree = {"b": [torch.arange(3.0), (np.int64(4), 2.5)],
            "a": torch.tensor([[1, 2]], dtype=torch.int32), "c": 7}
    ckpt.save(str(tmp_path / "state"), tree)
    like = {"a": torch.zeros(1, 2, dtype=torch.int32),
            "b": [torch.zeros(3), (np.int64(0), 0.0)], "c": 0}
    out = ckpt.load(str(tmp_path / "state.npz"), like)
    assert torch.equal(out["a"], tree["a"]) and out["a"].dtype == torch.int32
    assert torch.equal(out["b"][0], tree["b"][0])
    assert isinstance(out["b"][1], tuple) and out["b"][1][1] == 2.5
    assert out["c"] == 7 and type(out["c"]) is int
    with pytest.raises(ValueError, match="different state structure"):
        ckpt.load(str(tmp_path / "state"), {"a": like["a"]})


def test_archives_read_in_both_packages(tmp_path):
    from multigrad_tpu.utils import checkpoint as jax_ckpt
    tree = {"u": np.array([1.5, -2.0], np.float32), "step": np.int32(3)}
    jax_ckpt.save(str(tmp_path / "jax"), tree)
    got = ckpt.load(str(tmp_path / "jax"), {"u": torch.zeros(2), "step": 0})
    assert torch.equal(got["u"], torch.tensor([1.5, -2.0])) \
        and got["step"] == 3
    ckpt.save(str(tmp_path / "port"), {"u": torch.tensor([1.5, -2.0]),
                                       "step": 3})
    back = jax_ckpt.load(str(tmp_path / "port"), tree)
    np.testing.assert_array_equal(np.asarray(back["u"]), tree["u"])
    assert int(back["step"]) == 3


def test_format_version_rejected(tmp_path):
    ckpt.save(str(tmp_path / "s"), {"x": np.zeros(2)})
    data = dict(np.load(tmp_path / "s.npz"))
    data["__meta__"] = np.frombuffer(b'{"version": 9, "n": 1, "is_key": []}',
                                     dtype=np.uint8)
    np.savez(tmp_path / "s.npz", **data)
    with pytest.raises(ValueError, match="format version 9"):
        ckpt.load(str(tmp_path / "s"), {"x": np.zeros(2)})


def test_checkpointed_trajectory_matches_jax(tmp_path):
    import jax.numpy as jnp

    from multigrad_tpu.models.smf import SMFModel as JaxSMF
    from multigrad_tpu.models.smf import make_smf_data as jax_data

    jax_model = JaxSMF(aux_data=jax_data(4_000))
    aux = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jax_model.aux_data.items()}
    port = SMFModel(aux_data=aux_from_numpy(aux, device=CPU))
    want = jax_model.run_adam(guess=jnp.asarray(GUESS), nsteps=12,
                              learning_rate=0.02, progress=False,
                              param_bounds=BOUNDS,
                              checkpoint_dir=str(tmp_path / "jax"),
                              checkpoint_every=5)
    got = _fit(port, tmp_path / "port", param_bounds=BOUNDS,
               checkpoint_every=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
