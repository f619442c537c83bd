"""The port's streaming data subsystem: the counterparts of
``tests/test_streaming.py`` and parity with the JAX package.

The chunk plan against ``multigrad_tpu.data.plan_chunks`` (every field
equal); the sources, the prefetcher and ``StreamStats`` on the CPU; the
streamed SMF model against the resident one in the port at the JAX
tests' sizes (10,001 halos in chunks of 1,536, ragged both ways) and
tolerance (rtol 1e-5); prefetch off against on, and the scan path
against the two-pass path, exactly (the same ops on the same chunks in
the same order); the port's streamed model against the JAX package's
(``comm=None``) on the same numpy halos at ``tests/test_torch_smf.py``'s
limits (sumstats and loss rtol 1e-5, gradient rtol 1e-4); checkpointed
streamed Adam bit for bit; and two gloo ranks, each reading its own rows
of every chunk, against one process's resident model (rtol 1e-5), the
all-reduces counted: 2 a streamed loss and gradient, 1 a sumstats or
Jacobian pass, at 1 chunk and at 5.

The ranks run this file as a script, so it imports no JAX at the top:
the tests that compare with the JAX package import it inside.
"""
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from multigrad_tpu_torch import global_comm
from multigrad_tpu_torch.core.model import resolve_remat_policy
from multigrad_tpu_torch.data import (ArraySource, ChunkPrefetcher,
                                      MemmapSource, NpzSource,
                                      StreamingOnePointModel, as_source,
                                      plan_chunks, prefetch_chunks)
from multigrad_tpu_torch.data.source import (_ChunkRows, _npz_member_shape,
                                             _shard_span)
from multigrad_tpu_torch.models import (ParamTuple, SMFModel,
                                        aux_from_numpy, make_smf_data)
from multigrad_tpu_torch.utils.profiling import StreamStats

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
N_RAGGED = 10_001  # 10_001 % 2 == 1 and % 1536 != 0: doubly ragged
CHUNK_ROWS = 1536
PARAMS = ParamTuple(log_shmrat=-1.7, sigma_logsm=0.35)
TIMEOUT_S = 120
# Two gloo ranks: one chunk (twice the catalog) and five.
GLOO_CHUNKS = {1: 2 * N_RAGGED, 5: -(-N_RAGGED // 5)}


def _resident(n=N_RAGGED, model_cls=SMFModel):
    return model_cls(aux_data=make_smf_data(n, device=CPU))


def _streaming(n=N_RAGGED, chunk_rows=CHUNK_ROWS, model_cls=SMFModel,
               comm=None, stream=None, **kwargs):
    """The SMF model of ``n`` halos with its halos streamed; the resident
    aux describes the whole catalog (``volume`` is that of all ``n``)."""
    aux = make_smf_data(n, device=CPU)
    log_mh = aux.pop("log_halo_masses").numpy()
    return StreamingOnePointModel(
        model=model_cls(aux_data=aux, comm=comm),
        streams={"log_halo_masses": log_mh if stream is None else stream},
        chunk_rows=chunk_rows, **kwargs)


# --------------------------------------------------------------------- #
# Chunk plan
# --------------------------------------------------------------------- #
PLAN_GRID = [(1024, 256, 4), (1000, 256, 4), (1000, 100, 8), (10, 256, 4),
             (1, 1, 1), (7, 3, 2), (5, 10, 3), (N_RAGGED, CHUNK_ROWS, 1),
             (N_RAGGED, CHUNK_ROWS, 4), (N_RAGGED, 2 * N_RAGGED, 2)]


@pytest.mark.parametrize("n_rows,chunk_rows,n_shards", PLAN_GRID)
def test_plan_chunks_matches_jax(n_rows, chunk_rows, n_shards):
    from multigrad_tpu.data import plan_chunks as jax_plan_chunks
    want = jax_plan_chunks(n_rows, chunk_rows, n_shards)
    got = plan_chunks(n_rows, chunk_rows, n_shards)
    for name in ("n_rows", "n_shards", "shard_rows", "rows_per_chunk",
                 "n_chunks", "pad_rows"):
        assert getattr(got, name) == getattr(want, name), name
    assert [(c.index, c.start, c.stop, c.pad, c.rows) for c in got.chunks] \
        == [(c.index, c.start, c.stop, c.pad, c.rows) for c in want.chunks]


def test_plan_chunks_validates():
    with pytest.raises(ValueError, match="n_rows"):
        plan_chunks(0, 16)
    with pytest.raises(ValueError, match="chunk_rows"):
        plan_chunks(16, 0)


@pytest.mark.parametrize("n_rows,chunk_rows,n_shards", PLAN_GRID)
def test_shards_tile_each_padded_chunk(n_rows, chunk_rows, n_shards):
    # Shard s of chunk k: global rows [k·R + s·R/S, k·R + (s+1)·R/S),
    # so the shards' padded rows, in rank order, are the padded chunk.
    src = ArraySource(np.arange(float(n_rows)))
    plan = src.plan(chunk_rows, n_shards)
    for spec in plan.chunks:
        parts = [np.asarray(src._chunk_rows(_shard_span(plan, spec.index, s)))
                 for s in range(n_shards)]
        assert all(p.shape == (plan.shard_rows,) for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts),
                                      src.load_chunk(spec))


# --------------------------------------------------------------------- #
# Sources
# --------------------------------------------------------------------- #
def test_array_source_read_and_pad():
    src = ArraySource(np.arange(10.0))
    assert len(src) == 10
    plan = src.plan(4, n_shards=2)
    np.testing.assert_array_equal(src.read(2, 5), [2.0, 3.0, 4.0])
    last = plan.chunks[-1]
    chunk = src.load_chunk(last, pad_value=np.inf)
    assert chunk.shape == (4,)
    np.testing.assert_array_equal(chunk[:2], [8.0, 9.0])
    assert np.all(np.isinf(chunk[2:]))


def test_chunk_rows_pad_in_place():
    # The prefetcher's staging path: the rows copied into a buffer of the
    # padded shape and the tail padded there, equal to load_chunk.
    src = ArraySource(np.arange(20.0).reshape(10, 2))
    spec = src.plan(4).chunks[-1]
    rows = src._chunk_rows(spec, pad_value=-1.0)
    assert isinstance(rows, _ChunkRows) and rows.shape == (4, 2)
    assert rows.nbytes == 4 * 2 * 8
    out = np.full(rows.shape, 7.0)
    rows.copy_into(out)
    np.testing.assert_array_equal(out, src.load_chunk(spec, pad_value=-1.0))
    np.testing.assert_array_equal(np.asarray(rows), out)


def test_npz_source(tmp_path):
    path = str(tmp_path / "catalog.npz")
    arr = np.arange(20.0).reshape(10, 2)
    np.savez(path, halos=arr)
    src = NpzSource(path, "halos")
    assert src.n_rows == 10
    np.testing.assert_array_equal(src.read(3, 6), arr[3:6])
    with pytest.raises(KeyError, match="nope"):
        NpzSource(path, "nope")


def test_npz_header_walk(tmp_path, monkeypatch):
    # The shape comes from the member's header: the member is not
    # decompressed (its full read would raise here).
    from multigrad_tpu.data.source import \
        _npz_member_shape as jax_member_shape
    path = str(tmp_path / "catalog.npz")
    np.savez_compressed(path, halos=np.zeros((1000, 3), np.float32))
    with np.load(path) as archive:
        want = jax_member_shape(archive, "halos")
        monkeypatch.setattr(type(archive), "__getitem__", lambda *a: 1 / 0)
        assert _npz_member_shape(archive, "halos") == want == (1000, 3)


def test_memmap_source_npy(tmp_path):
    path = str(tmp_path / "catalog.npy")
    arr = np.linspace(0, 1, 17).astype(np.float32)
    np.save(path, arr)
    src = MemmapSource(path)
    assert src.n_rows == 17
    np.testing.assert_array_equal(src.read(5, 9), arr[5:9])
    # reads are plain host copies, not live mappings
    assert not isinstance(src.read(0, 4), np.memmap)


def test_memmap_source_raw_requires_meta(tmp_path):
    path = str(tmp_path / "catalog.bin")
    arr = np.arange(12.0, dtype=np.float64)
    arr.tofile(path)
    with pytest.raises(ValueError, match="dtype"):
        MemmapSource(path)
    src = MemmapSource(path, dtype=np.float64, shape=(12,))
    np.testing.assert_array_equal(src.read(0, 3), [0.0, 1.0, 2.0])


def test_as_source_coercions(tmp_path):
    src = ArraySource(np.arange(4.0))
    assert as_source(src) is src
    assert isinstance(as_source(np.arange(4.0)), ArraySource)
    path = str(tmp_path / "c.npy")
    np.save(path, np.arange(4.0))
    assert isinstance(as_source(path), MemmapSource)
    with pytest.raises(ValueError, match="NpzSource"):
        as_source(str(tmp_path / "c.npz"))


# --------------------------------------------------------------------- #
# Prefetcher (CPU)
# --------------------------------------------------------------------- #
def test_prefetcher_yields_all_chunks_in_order():
    chunks = [np.full(8, float(k)) for k in range(5)]
    stats = StreamStats()
    got = []
    for k, dev in ChunkPrefetcher(lambda k: chunks[k], 5, device=CPU,
                                  stats=stats):
        assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
        got.append((k, float(dev[0])))
    assert got == [(k, float(k)) for k in range(5)]
    assert stats.chunks == 5
    assert stats.bytes_streamed == 5 * chunks[0].nbytes


def test_prefetcher_holds_at_most_two_buffers():
    # Slow consumer, instant producer: the tokens cap the buffers held at
    # two (double buffering) whatever the backlog.
    stats = StreamStats()
    for _k, _dev in ChunkPrefetcher(lambda k: np.zeros(16), 8, device=CPU,
                                    stats=stats):
        time.sleep(0.01)
    assert stats.max_live_buffers <= 2
    assert stats.chunks == 8


def test_prefetcher_propagates_loader_errors():
    def load(k):
        if k == 2:
            raise RuntimeError("disk on fire")
        return np.zeros(4)

    with pytest.raises(RuntimeError, match="disk on fire"):
        for _ in ChunkPrefetcher(load, 5, device=CPU):
            pass


def test_prefetcher_close_unblocks_producer():
    pf = ChunkPrefetcher(lambda k: np.zeros(4), 100, device=CPU)
    it = iter(pf)
    next(it)
    pf.close()  # must not hang on the backlogged loader
    assert not pf._thread.is_alive()


def test_prefetcher_starts_loading_at_construction():
    started = threading.Event()

    def load(k):
        started.set()
        return np.zeros(4)

    pf = ChunkPrefetcher(load, 3, device=CPU)
    assert started.wait(5.0)  # before any iteration
    pf.close()


def test_prefetch_chunks_sync_path_matches():
    chunks = [np.full(4, float(k)) for k in range(3)]
    stats = StreamStats()
    got = [float(dev[0]) for _k, dev in prefetch_chunks(
        lambda k: chunks[k], 3, device=CPU, prefetch=False, stats=stats)]
    assert got == [0.0, 1.0, 2.0]
    assert stats.chunks == 3
    assert stats.max_live_buffers == 1


def test_prefetcher_keeps_lists_and_pads_rows():
    # A list of leaves stays a list; chunk rows are padded as they load.
    src = ArraySource(np.arange(10, dtype=np.float32))
    plan = src.plan(4)
    for prefetch in (True, False):
        got = [(k, [t.clone() for t in dev]) for k, dev in prefetch_chunks(
            lambda k: [src._chunk_rows(plan.chunks[k]),
                       src.load_chunk(plan.chunks[k], 0.0)], plan.n_chunks,
            device=CPU, prefetch=prefetch)]
        assert [k for k, _ in got] == [0, 1, 2]
        np.testing.assert_array_equal(got[-1][1][0].numpy(),
                                      [8, 9, np.inf, np.inf])
        np.testing.assert_array_equal(got[-1][1][1].numpy(), [8, 9, 0, 0])


def test_prefetchers_under_thread_stress():
    # More consumer threads than cores, each with its own prefetcher, the
    # interpreter switching threads often: every chunk arrives once, in
    # order, whole, and no prefetcher holds more than two buffers.
    n_streams, n_chunks, width = 12, 40, 64
    results, errors = [None] * n_streams, []

    def consume(i):
        try:
            stats = StreamStats()
            pf = ChunkPrefetcher(
                lambda k: np.full(width, 1000.0 * i + k), n_chunks,
                device=CPU, stats=stats)
            got = [(k, chunk.clone()) for k, chunk in pf]
            results[i] = (got, stats)
        except BaseException as e:  # surfaced below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not errors and not any(t.is_alive() for t in threads)
    for i, (got, stats) in enumerate(results):
        assert [k for k, _ in got] == list(range(n_chunks))
        assert all(bool((chunk == 1000.0 * i + k).all()) for k, chunk in got)
        assert stats.chunks == n_chunks and stats.max_live_buffers <= 2


def test_stream_stats_summary_matches_jax():
    from multigrad_tpu.utils.profiling import StreamStats as JaxStreamStats
    ours, theirs = StreamStats(), JaxStreamStats()
    for stats in (ours, theirs):
        stats.add("sumstats", bytes_streamed=4096, chunks=1, fill_s=0.125)
        stats.add("sumstats", bytes_streamed=4096, chunks=1, stall_s=0.0625)
        stats.saw_live_buffers(1)
        stats.saw_live_buffers(2)
        stats.add("sumstats", wall_s=1.5)
        stats.add("vjp", bytes_streamed=8192, chunks=2, fill_s=0.25,
                  stall_s=0.5)
        stats.add("vjp", wall_s=2.0)
        stats.add(None, wall_s=0.25)
    assert ours.summary() == theirs.summary()
    assert ours.stall_fraction == theirs.stall_fraction
    assert ours.overlap_fraction == theirs.overlap_fraction


# --------------------------------------------------------------------- #
# Streaming against resident, in the port
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def resident():
    model = _resident()
    loss, grad = model.calc_loss_and_grad_from_params(PARAMS)
    return model, float(loss), grad.numpy()


@pytest.fixture(scope="module")
def two_pass():
    sm = _streaming()
    loss, grad = sm.calc_loss_and_grad_from_params(PARAMS)
    return sm, loss, grad


def test_streamed_sumstats_match_resident(resident):
    model, _, _ = resident
    y_res = model.calc_sumstats_from_params(PARAMS).numpy()
    y_str = _streaming().calc_sumstats_from_params(PARAMS).numpy()
    np.testing.assert_allclose(y_str, y_res, rtol=1e-5)


def test_two_pass_streamed_loss_and_grad_match_resident(resident, two_pass):
    _, loss_r, grad_r = resident
    sm, loss_s, grad_s = two_pass
    np.testing.assert_allclose(float(loss_s), loss_r, rtol=1e-5)
    np.testing.assert_allclose(grad_s.numpy(), grad_r, rtol=1e-5)
    # both passes streamed the full plan; double buffering held
    stats = sm.last_stats
    assert stats.chunks == 2 * sm.plan().n_chunks == 14
    assert stats.bytes_streamed == 14 * CHUNK_ROWS * 4
    assert stats.max_live_buffers <= 2
    assert set(stats.passes) == {"sumstats", "vjp"}


SCAN_POLICIES = ["dots", "nothing", None, "everything",
                 "dots_with_no_batch_dims", "callable"]


@pytest.mark.parametrize("policy", SCAN_POLICIES)
def test_scan_path_matches_two_pass(resident, two_pass, policy):
    # Exactly the two-pass numbers: the same chunks' VJPs, added up in
    # chunk order, whatever each chunk's forward saved.
    if policy == "callable":
        from torch.utils.checkpoint import CheckpointPolicy
        policy = lambda ctx, op, *a, **k: CheckpointPolicy.PREFER_RECOMPUTE  # noqa: E731
    _, loss_r, grad_r = resident
    _, loss_s, grad_s = two_pass
    sm = _streaming(remat_policy=policy)
    loss_c, grad_c = sm.calc_loss_and_grad_scan(PARAMS)
    np.testing.assert_allclose(float(loss_c), loss_r, rtol=1e-5)
    np.testing.assert_allclose(grad_c.numpy(), grad_r, rtol=1e-5)
    assert torch.equal(loss_c, loss_s) and torch.equal(grad_c, grad_s)
    # The chunk stack is resident and kept: (n_chunks, rows).
    stack = sm._materialize_scan_stack(sm.plan())
    assert tuple(stack[0].shape) == (7, CHUNK_ROWS)
    assert sm._materialize_scan_stack(sm.plan()) is stack


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        resolve_remat_policy("sometimes")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _streaming(remat_policy="sometimes").calc_loss_and_grad_scan(PARAMS)


@pytest.mark.parametrize("chunk_rows", [512, 4096, 2 * N_RAGGED])
def test_chunk_size_invariance(resident, chunk_rows):
    # Totals and gradients are chunk-size independent (additivity).
    _, loss_r, grad_r = resident
    loss_s, grad_s = _streaming(chunk_rows=chunk_rows) \
        .calc_loss_and_grad_from_params(PARAMS)
    np.testing.assert_allclose(float(loss_s), loss_r, rtol=1e-5)
    np.testing.assert_allclose(grad_s.numpy(), grad_r, rtol=1e-5)


def test_no_prefetch_path_matches(two_pass):
    _, loss_s, grad_s = two_pass
    sm = _streaming(prefetch=False)
    loss, grad = sm.calc_loss_and_grad_from_params(PARAMS)
    assert torch.equal(loss, loss_s) and torch.equal(grad, grad_s)
    assert sm.last_stats.max_live_buffers == 1


def test_streaming_from_memmap_source(tmp_path, resident, two_pass):
    # End to end out of core: the catalog on disk, never fully resident.
    _, loss_r, grad_r = resident
    path = str(tmp_path / "halos.npy")
    np.save(path, _resident().aux_data["log_halo_masses"].numpy())
    sm = _streaming(stream=MemmapSource(path))
    loss_s, grad_s = sm.calc_loss_and_grad_from_params(PARAMS)
    np.testing.assert_allclose(float(loss_s), loss_r, rtol=1e-5)
    np.testing.assert_allclose(grad_s.numpy(), grad_r, rtol=1e-5)
    assert torch.equal(grad_s, two_pass[2])


@dataclass
class SMFModelWithAux(SMFModel):
    """SMF variant exercising the additive-aux streaming contract."""

    sumstats_func_has_aux: bool = True

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        y = super().calc_partial_sumstats_from_params(params,
                                                      randkey=randkey)
        # Additive aux: the total smoothed count.
        return y, torch.sum(y)

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        base = super().calc_loss_from_sumstats(sumstats)
        return base + 0.1 * torch.log1p(sumstats_aux)


def test_streamed_with_sumstats_aux_matches_resident():
    res = _resident(model_cls=SMFModelWithAux)
    loss_r, grad_r = res.calc_loss_and_grad_from_params(PARAMS)
    sm = _streaming(model_cls=SMFModelWithAux)
    y_tot, aux_tot = sm.calc_sumstats_from_params(PARAMS)
    y_res, aux_res = res.calc_sumstats_from_params(PARAMS)
    np.testing.assert_allclose(y_tot.numpy(), y_res.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(aux_tot), float(aux_res), rtol=1e-5)
    loss_s, grad_s = sm.calc_loss_and_grad_from_params(PARAMS)
    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(grad_s.numpy(), grad_r.numpy(), rtol=1e-5)
    loss_c, grad_c = sm.calc_loss_and_grad_scan(PARAMS)
    assert torch.equal(loss_c, loss_s) and torch.equal(grad_c, grad_s)


@pytest.mark.parametrize("use_scan", [False, True])
def test_streamed_adam_tracks_resident_fit(use_scan):
    n, steps = 4_000, 5
    traj_r = _resident(n).run_adam(guess=(-1.5, 0.4), nsteps=steps,
                                   learning_rate=0.05, progress=False)
    traj_s = _streaming(n, chunk_rows=1024).run_adam(
        guess=(-1.5, 0.4), nsteps=steps, learning_rate=0.05,
        progress=False, use_scan=use_scan)
    assert tuple(traj_s.shape) == (steps + 1, 2)
    np.testing.assert_allclose(traj_s.numpy(), traj_r.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_streamed_adam_with_bounds():
    fit = dict(guess=(-1.5, 0.4), nsteps=3, learning_rate=0.05,
               param_bounds=[(-3.0, 0.0), (0.05, 1.0)], progress=False)
    traj = _streaming(2_000, chunk_rows=1024).run_adam(**fit)
    assert tuple(traj.shape) == (4, 2)
    assert bool((traj[:, 0] > -3.0).all()) and bool((traj[:, 1] > 0.05).all())
    np.testing.assert_allclose(traj.numpy(),
                               _resident(2_000).run_adam(**fit).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_streaming_model_validates():
    aux = make_smf_data(100, device=CPU)
    template = SMFModel(aux_data=aux)
    # resident aux already holds the streamed key -> must refuse
    with pytest.raises(ValueError, match="disjoint"):
        StreamingOnePointModel(
            model=template,
            streams={"log_halo_masses": np.arange(8.0)}, chunk_rows=4)
    del aux["log_halo_masses"]
    with pytest.raises(ValueError, match="at least one"):
        StreamingOnePointModel(model=template, streams={}, chunk_rows=4)
    with pytest.raises(ValueError, match="row-aligned"):
        StreamingOnePointModel(
            model=SMFModel(aux_data=aux),
            streams={"a": np.arange(8.0), "b": np.arange(9.0)},
            chunk_rows=4)


@pytest.mark.parametrize("knob", ["chunk_rows", "remat_policy"])
def test_streaming_auto_is_not_ported(knob):
    kwargs = {"chunk_rows": CHUNK_ROWS, knob: "auto"}
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        _streaming(**kwargs)


def test_replace_aux_rebinds():
    model = _resident(1_000)
    rebound = model.replace_aux(volume=123.0)
    assert rebound.aux_data["volume"] == 123.0
    assert model.aux_data["volume"] != 123.0  # original untouched
    assert rebound is not model and type(rebound) is SMFModel
    with pytest.raises(TypeError, match="dict aux_data"):
        SMFModel(aux_data=[1.0]).replace_aux(volume=1.0)


def test_chunk_programs_need_dict_aux():
    program = SMFModel(aux_data=(torch.zeros(2),)).chunk_sumstats_fn(
        ("log_halo_masses",))
    with pytest.raises(TypeError, match="streaming requires dict aux_data"):
        program(torch.tensor([-2.0, 0.2]), [torch.zeros(4)])


def test_chunk_programs_return_local_partials(resident):
    # Each chunk program gives one chunk's partial; the partials add up
    # to the resident totals and gradient.
    model, _, grad_r = resident
    log_mh = model.aux_data["log_halo_masses"]
    aux = {k: v for k, v in model.aux_data.items() if k != "log_halo_masses"}
    template = SMFModel(aux_data=aux)
    names = ("log_halo_masses",)
    p = torch.tensor(PARAMS)
    halves = [[log_mh[:5_000]], [log_mh[5_000:]]]
    sumstats = template.chunk_sumstats_fn(names)
    y = sumstats(p, halves[0]) + sumstats(p, halves[1])
    np.testing.assert_allclose(y.numpy(),
                               model.calc_sumstats_from_params(p).numpy(),
                               rtol=1e-5)
    ct = model.calc_dloss_dsumstats(y)
    vjp = template.chunk_vjp_fn(names)
    np.testing.assert_allclose(
        (vjp(p, halves[0], ct) + vjp(p, halves[1], ct)).numpy(), grad_r,
        rtol=1e-5)
    jac = template.chunk_jac_fn(names)
    (y0, j0), (y1, j1) = jac(p, halves[0]), jac(p, halves[1])
    y_r, j_r = model.calc_sumstats_and_jac_from_params(p)
    np.testing.assert_allclose((j0 + j1).numpy(), j_r.numpy(), rtol=1e-5,
                               atol=1e-6 * float(j_r.abs().max()))


# --------------------------------------------------------------------- #
# Parity with the JAX package (comm=None), the same numpy halos
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_pair():
    """(JAX streamed model, port streamed model) over the same halos."""
    import jax.numpy as jnp
    from multigrad_tpu.data import \
        StreamingOnePointModel as JaxStreamingOnePointModel
    from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
    from multigrad_tpu.models.smf import load_halo_masses, make_smf_data \
        as jax_make_smf_data
    log_mh = np.asarray(jnp.log10(load_halo_masses(N_RAGGED)))
    jax_aux = jax_make_smf_data(N_RAGGED, comm=None)
    del jax_aux["log_halo_masses"]
    port_aux = aux_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                   else v) for k, v in jax_aux.items()},
                              device=CPU)
    jax_sm = JaxStreamingOnePointModel(
        model=JaxSMFModel(aux_data=jax_aux, comm=None),
        streams={"log_halo_masses": log_mh}, chunk_rows=CHUNK_ROWS)
    port_sm = StreamingOnePointModel(
        model=SMFModel(aux_data=port_aux),
        streams={"log_halo_masses": log_mh}, chunk_rows=CHUNK_ROWS)
    return jax_sm, port_sm


def test_streamed_sumstats_match_jax(jax_pair):
    jax_sm, port_sm = jax_pair
    np.testing.assert_allclose(
        port_sm.calc_sumstats_from_params(PARAMS).numpy(),
        np.asarray(jax_sm.calc_sumstats_from_params(np.array(PARAMS))),
        rtol=1e-5)


@pytest.mark.parametrize("path", ["two_pass", "scan"])
def test_streamed_loss_and_grad_match_jax(jax_pair, path):
    jax_sm, port_sm = jax_pair
    name = "calc_loss_and_grad_from_params" if path == "two_pass" \
        else "calc_loss_and_grad_scan"
    loss_j, grad_j = getattr(jax_sm, name)(np.array(PARAMS, np.float32))
    loss_p, grad_p = getattr(port_sm, name)(PARAMS)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_j),
                               rtol=1e-4)


def test_streamed_jacobian_matches_jax(jax_pair):
    jax_sm, port_sm = jax_pair
    y_j, jac_j = jax_sm.calc_sumstats_and_jac_from_params(
        np.array(PARAMS, np.float32))
    y_p, jac_p = port_sm.calc_sumstats_and_jac_from_params(PARAMS)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), rtol=1e-5)
    jac_j = np.asarray(jac_j)
    np.testing.assert_allclose(jac_p.numpy(), jac_j, rtol=1e-4,
                               atol=1e-6 * np.abs(jac_j).max())


# --------------------------------------------------------------------- #
# Checkpointed streamed Adam
# --------------------------------------------------------------------- #
class _Counted(SMFModel):
    """An SMF model that counts its chunk evaluations and can raise from
    one (a preemption mid-fit)."""
    calls = 0
    fail_at = None

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        type(self).calls += 1
        if type(self).calls == type(self).fail_at:
            raise RuntimeError("simulated preemption")
        return super().calc_partial_sumstats_from_params(params, randkey)


@pytest.mark.parametrize("bounds", [None, [(-3.0, 0.0), (0.05, 1.0)]])
def test_streamed_adam_checkpoint_resumes_bit_for_bit(tmp_path, bounds):
    fit = dict(guess=(-1.5, 0.4), nsteps=8, learning_rate=0.05,
               param_bounds=bounds, progress=False)
    plain = _streaming(2_000, chunk_rows=512).run_adam(**fit)
    ckpt = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    # 4 chunks, 2 passes: 8 chunk evaluations a step; the 41st is in step
    # 6, after the segments of steps 1-3 were written.
    _Counted.calls, _Counted.fail_at = 0, 41
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _streaming(2_000, chunk_rows=512, model_cls=_Counted).run_adam(
            **fit, **ckpt)
    _Counted.calls, _Counted.fail_at = 0, None
    resumed = _streaming(2_000, chunk_rows=512, model_cls=_Counted) \
        .run_adam(**fit, **ckpt)
    assert _Counted.calls == (8 - 3) * 8  # steps 4-8 only
    assert torch.equal(resumed, plain)
    # A finished fit is a pure read: no chunk is evaluated.
    _Counted.calls, _Counted.fail_at = 0, 1
    again = _streaming(2_000, chunk_rows=512, model_cls=_Counted).run_adam(
        **fit, **ckpt)
    assert _Counted.calls == 0 and torch.equal(again, plain)


# --------------------------------------------------------------------- #
# Two gloo ranks, each reading its own rows of every chunk
# --------------------------------------------------------------------- #
def _run_rank(rank, world, init_file, out_file):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        comm = global_comm()
        out = {}
        sizes = []
        real = dist.all_reduce

        def counting(tensor, *args, **kwargs):
            sizes.append(tensor.numel())
            return real(tensor, *args, **kwargs)

        for n_chunks, chunk_rows in GLOO_CHUNKS.items():
            sm = _streaming(chunk_rows=chunk_rows, comm=comm)
            assert sm.plan().n_chunks == n_chunks
            dist.all_reduce = counting
            try:
                for name, call in (
                        ("lg", sm.calc_loss_and_grad_from_params),
                        ("y", sm.calc_sumstats_from_params),
                        ("jac", sm.calc_sumstats_and_jac_from_params),
                        ("scan", sm.calc_loss_and_grad_scan)):
                    sizes.clear()
                    result = call(PARAMS)
                    out[f"{name}{n_chunks}_sizes"] = np.array(sizes)
                    for i, part in enumerate(result if isinstance(
                            result, tuple) else (result,)):
                        out[f"{name}{n_chunks}_{i}"] = part.numpy()
            finally:
                dist.all_reduce = real
            out[f"rows{n_chunks}"] = sm.last_stats.bytes_streamed // 4
        np.savez(out_file, **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_ranks():
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="2")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             init_file, outs[r]], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
        except subprocess.TimeoutExpired:
            pytest.fail(f"a rank did not finish within {TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, logs):
            assert p.returncode == 0, text
        return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("n_chunks", sorted(GLOO_CHUNKS))
def test_two_rank_streamed_matches_resident(gloo_ranks, resident, n_chunks):
    model, loss_r, grad_r = resident
    y_r, jac_r = model.calc_sumstats_and_jac_from_params(PARAMS)
    for r in gloo_ranks:
        for path in ("lg", "scan"):
            np.testing.assert_allclose(r[f"{path}{n_chunks}_0"], loss_r,
                                       rtol=1e-5)
            np.testing.assert_allclose(r[f"{path}{n_chunks}_1"], grad_r,
                                       rtol=1e-5)
        np.testing.assert_allclose(r[f"y{n_chunks}_0"], y_r.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(r[f"jac{n_chunks}_1"], jac_r.numpy(),
                                   rtol=1e-5,
                                   atol=1e-6 * float(jac_r.abs().max()))
        # Every rank ends with the same totals.
        np.testing.assert_array_equal(r[f"lg{n_chunks}_1"],
                                      gloo_ranks[0][f"lg{n_chunks}_1"])
    # Each rank streamed its own half of every chunk, in the Jacobian pass.
    plan = plan_chunks(N_RAGGED, GLOO_CHUNKS[n_chunks], 2)
    assert [int(r[f"rows{n_chunks}"]) for r in gloo_ranks] == \
        [plan.n_chunks * plan.shard_rows] * 2


@pytest.mark.parametrize("n_chunks", sorted(GLOO_CHUNKS))
def test_two_rank_all_reduces_counted(gloo_ranks, n_chunks):
    # One all-reduce a pass whatever the number of chunks: y (10), then
    # the gradient (2); y and J joined (10 + 20).
    for r in gloo_ranks:
        assert r[f"lg{n_chunks}_sizes"].tolist() == [10, 2]
        assert r[f"scan{n_chunks}_sizes"].tolist() == [10, 2]
        assert r[f"y{n_chunks}_sizes"].tolist() == [10]
        assert r[f"jac{n_chunks}_sizes"].tolist() == [30]


if __name__ == "__main__":
    _run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
