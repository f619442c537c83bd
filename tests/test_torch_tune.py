"""The port's autotuner (``multigrad_tpu_torch.tune``) on the CPU: each
test of the JAX package's ``tests/test_tune.py`` ported, and the parts
both packages share held against each other.

* table persistence, the two-stage loop and its warm start, the noise
  rule, the op alias, the collapse of donate variants, the bucket ladder
  and the scheduler's boot on it, the streaming knobs, the regress gate
  and the report's ``tune`` section, the CLI's receipt (``--device
  cpu``), as the JAX tests;
* the canonical fused-bins fixture (slow-marked, as there): which mode
  wins is measured, not asserted (the JAX package's verdicts are a
  TPU's); the two regimes key apart and ``"auto"`` resolves to each
  winner;
* ``make_key``, ``model_shape_key``, ``rows_bucket``, ``aux_model_key``
  and the candidate lists equal to the JAX package's on the same data;
  on the card no chunk candidates for the SMF model;
* a table written by either package resolves the same knobs in the
  other (the key's tags explicit where they must match);
* on a cold table every ``"auto"`` resolves to the JAX package's
  hand-set default on the same data.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import multigrad_tpu_torch as mgt
from multigrad_tpu import tune as jtune
from multigrad_tpu.models import smf as jsmf
from multigrad_tpu_torch.models.smf import SMFModel, make_smf_data
from multigrad_tpu_torch.serve.compile_cache import DEFAULT_BUCKETS
from multigrad_tpu_torch.serve.scheduler import FitScheduler
from multigrad_tpu_torch.tune import (TuningTable, make_key,
                                      model_shape_key, rows_bucket,
                                      tune_buckets, tune_model,
                                      tune_streaming, within_noise)
from multigrad_tpu_torch.tune.resolve import (aux_model_key,
                                              resolve_donate_carry,
                                              resolve_stream_knobs)
from multigrad_tpu_torch.tune.space import (bucket_candidates,
                                            model_candidates,
                                            streaming_candidates)
from multigrad_tpu_torch.tune.tuner import model_key

CPU = "cpu"
GUESS = np.array([-1.0, 0.5])


def small_smf(n=4000, **kw):
    return SMFModel(aux_data=make_smf_data(n, device=CPU, **kw))


@pytest.fixture(autouse=True)
def _cold_default_table(tmp_path, monkeypatch):
    # No test reads or writes the default table beside the kernel
    # libraries.
    monkeypatch.setenv("MGT_TUNING_TABLE", str(tmp_path / "default.json"))


# ------------------------------------------------------------------ #
# Tuning table
# ------------------------------------------------------------------ #
def test_table_round_trip_and_merge(tmp_path):
    path = str(tmp_path / "t.json")
    t1 = TuningTable(path)
    assert t1.lookup("model|X|rows2^10|cpu|cpu") is None
    t1.record("k1", {"bin_mode": "fused", "bin_window": 10},
              measured_s=0.1, predicted_s=0.09)
    t2 = TuningTable(path)
    entry = t2.lookup("k1")
    assert entry["knobs"] == {"bin_mode": "fused", "bin_window": 10}
    assert entry["measured_s"] == 0.1
    TuningTable(path).record("k2", {"chunk_size": None})
    assert set(TuningTable(path).entries()) == {"k1", "k2"}
    with open(path, "w") as f:
        f.write('{"entries": {"k1"')
    assert TuningTable(path).lookup("k1") is None


def test_table_across_real_process_restart(tmp_path):
    path = str(tmp_path / "t.json")
    TuningTable(path).record("model|SMFModel|rows2^12|e11|w11|cpu|cpu",
                             {"bin_mode": "dense"})
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "from multigrad_tpu_torch.tune.table import TuningTable\n"
         "e = TuningTable(sys.argv[1]).lookup("
         "'model|SMFModel|rows2^12|e11|w11|cpu|cpu')\n"
         "print(json.dumps(e['knobs']))", path],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "PYTHONPATH": mgt.__path__[0].rsplit("/", 1)[0]})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip()) == {"bin_mode": "dense"}


def test_default_table_beside_the_kernel_libraries(monkeypatch):
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.tune.table import default_table_path
    monkeypatch.delenv("MGT_TUNING_TABLE")
    assert default_table_path() == str(cuda_build.build_dir()) + \
        ".tuning.json"
    monkeypatch.setenv("MGT_TUNING_TABLE", "/x/t.json")
    assert default_table_path() == "/x/t.json"


# ------------------------------------------------------------------ #
# tune_model: two-stage loop + warm start
# ------------------------------------------------------------------ #
def test_tune_model_measures_then_warm_starts(tmp_path):
    table = TuningTable(str(tmp_path / "t.json"))
    model = small_smf()
    res = tune_model(model, GUESS, sigma_max=0.6, table=table,
                     reps=1, trial="eval")
    assert not res.warm and res.n_trials >= 2
    assert all(c["predicted_s"] is not None for c in res.candidates)
    assert sum(c["chosen"] for c in res.candidates) == 1
    assert all(c["roofline_frac"] > 0 for c in res.candidates
               if c["measured_s"] is not None)
    assert res.chosen["bin_mode"] in ("dense", "fused")
    entry = table.lookup(res.key)
    assert entry["knobs"] == res.chosen
    assert entry["baseline_s"] is not None
    res2 = tune_model(model, GUESS, sigma_max=0.6, table=table)
    assert res2.warm and res2.n_trials == 0
    assert res2.chosen == res.chosen
    res3 = tune_model(model, GUESS, sigma_max=0.6, table=table,
                      reps=1, trial="eval", force=True)
    assert not res3.warm and res3.n_trials >= 2
    assert mgt.tune_model is tune_model
    assert mgt.TuningTable is TuningTable


def test_within_noise_tolerance_rules():
    for fn in (within_noise, jtune.within_noise):
        assert fn(1.0, 1.05, pct=10.0, floor_ms=0.0)
        assert not fn(1.3, 1.0, pct=10.0, floor_ms=0.0)
        assert fn(0.0021, 0.001, pct=10.0, floor_ms=2.0)
        assert fn(0.9, 1.0, pct=0.0, floor_ms=0.0)


# ------------------------------------------------------------------ #
# The canonical fixture: the fused-bins pair of sigma regimes
# ------------------------------------------------------------------ #
@pytest.mark.slow  # measured A/B trials of both bin modes
def test_canonical_fused_bins_fixture(tmp_path, monkeypatch):
    """The JAX fixture's two regimes (window 10/41 at sigma~0.05, 33/41
    at sigma~0.2): both measured, keyed apart, and an "auto" model
    resolves to each winner.  Which mode wins is a measurement (the JAX
    package's fused-at-0.05, dense-at-0.2 verdicts are a TPU's)."""
    from multigrad_tpu_torch.models.galhalo_hist import (
        GalhaloHistModel, TRUTH, make_galhalo_hist_data)

    table_path = str(tmp_path / "t.json")
    monkeypatch.setenv("MGT_TUNING_TABLE", table_path)
    table = TuningTable(table_path)
    edges = np.linspace(7.0, 11.75, 41)
    obs = (5, 7, 9, 11, 13, 15)
    n = 120_000
    truth = np.asarray(TRUTH)
    tight = truth.copy()
    tight[8], tight[9] = 0.05, -0.005
    windows = {}
    for tag, params, sigma_max in (("sigma005", tight, 0.08),
                                   ("sigma02", truth, 0.32)):
        aux = make_galhalo_hist_data(n, bin_edges=edges, obs_indices=obs,
                                     device=CPU)
        res = tune_model(GalhaloHistModel(aux_data=aux), params,
                         sigma_max=sigma_max, table=table, reps=2,
                         trial="eval")
        chosen = [c for c in res.candidates if c["chosen"]][0]
        assert chosen["predicted_s"] is not None
        assert chosen["measured_s"] is not None
        auto = GalhaloHistModel(aux_data=make_galhalo_hist_data(
            n, bin_edges=edges, obs_indices=obs, bin_mode="auto",
            sigma_max=sigma_max, device=CPU))
        assert auto.aux_data["bin_mode"] == res.chosen["bin_mode"]
        if res.chosen["bin_mode"] == "fused":
            assert auto.aux_data["bin_window"] == res.chosen["bin_window"]
        windows[tag] = res.key.split("|")[4]
    assert windows == {"sigma005": "w10", "sigma02": "w33"}
    model_keys = [k for k in table.entries()
                  if k.startswith("model|GalhaloHistModel|")]
    assert len(model_keys) == 2


# ------------------------------------------------------------------ #
# "auto" resolution: cold-table fallbacks everywhere
# ------------------------------------------------------------------ #
def test_auto_resolution_cold_table():
    model = small_smf(bin_mode="auto", chunk_size="auto")
    assert model.aux_data["bin_mode"] == "dense"
    assert model.aux_data["chunk_size"] is None
    assert model.aux_data["bin_window"] == 11
    # The JAX package's cold resolution on the same data.
    jmodel = jsmf.SMFModel(aux_data=jsmf.make_smf_data(
        4000, bin_mode="auto", chunk_size="auto"))
    for knob in ("bin_mode", "bin_window", "chunk_size", "sigma_max"):
        assert model.aux_data[knob] == jmodel.aux_data[knob]
    from multigrad_tpu_torch.ops.binned import binned_erf_counts
    vals = torch.linspace(9.0, 10.0, 512)
    edges = torch.linspace(9, 10, 11)
    np.testing.assert_array_equal(
        binned_erf_counts(vals, edges, 0.1, bin_mode="auto").numpy(),
        binned_erf_counts(vals, edges, 0.1, bin_mode="dense").numpy())
    traj = model.run_adam(guess=GUESS, nsteps=3, progress=False)
    assert torch.isfinite(traj).all()


def test_auto_resolution_applies_table_entry(tmp_path, monkeypatch):
    table_path = str(tmp_path / "t.json")
    monkeypatch.setenv("MGT_TUNING_TABLE", table_path)
    model = small_smf(bin_mode="auto")
    key = model_key(model, bin_window=model.aux_data["bin_window"])
    TuningTable(table_path).record(
        key, {"bin_mode": "fused", "bin_window": 11,
              "chunk_size": 2048, "donate_carry": False})
    tuned = small_smf(bin_mode="auto", chunk_size="auto")
    assert tuned.aux_data["bin_mode"] == "fused"
    assert tuned.aux_data["bin_window"] == 11
    assert tuned.aux_data["chunk_size"] == 2048
    np.testing.assert_allclose(
        float(tuned.calc_loss_from_params(GUESS)),
        float(model.calc_loss_from_params(GUESS)), rtol=1e-6)
    assert resolve_donate_carry(tuned) is False
    assert resolve_donate_carry(small_smf(n=16_000)) is None


def test_windowless_sigma_aux_keys_agree(tmp_path, monkeypatch):
    table_path = str(tmp_path / "t.json")
    monkeypatch.setenv("MGT_TUNING_TABLE", table_path)
    aux = make_smf_data(4000, sigma_max=0.6, device=CPU)
    assert aux.get("bin_window") is None
    model = SMFModel(aux_data=aux)
    wkey = model_key(model, sigma_max=0.6)
    rkey = aux_model_key("SMFModel",
                         dict(aux, bin_mode="auto", chunk_size="auto"))
    assert wkey == rkey
    TuningTable(table_path).record(
        wkey, {"bin_mode": "fused", "bin_window": 11,
               "chunk_size": 2048})
    tuned = SMFModel(aux_data=dict(aux, bin_mode="auto",
                                   chunk_size="auto"))
    assert tuned.aux_data["bin_mode"] == "fused"
    assert tuned.aux_data["chunk_size"] == 2048


def test_tune_model_writes_op_alias(tmp_path, monkeypatch):
    table_path = str(tmp_path / "t.json")
    monkeypatch.setenv("MGT_TUNING_TABLE", table_path)
    model = small_smf(sigma_max=0.6)
    tune_model(model, GUESS, sigma_max=0.6,
               table=TuningTable(table_path), trial_steps=2, reps=1)
    keys = sorted(TuningTable(table_path).entries())
    aliases = [k for k in keys if "binned_erf_counts" in k]
    assert len(aliases) == 1
    assert "|w0|" not in aliases[0]
    from multigrad_tpu_torch.ops.binned import binned_erf_counts
    vals = model.aux_data["log_halo_masses"]
    edges = model.aux_data["smf_bin_edges"]
    np.testing.assert_allclose(
        binned_erf_counts(vals, edges, 0.1, bin_mode="auto").numpy(),
        binned_erf_counts(vals, edges, 0.1, bin_mode="dense").numpy(),
        rtol=1e-6)
    TuningTable(table_path).record(
        aliases[0], {"bin_mode": "fused", "bin_window": 11})
    window = int(aliases[0].split("|")[4][1:])
    np.testing.assert_allclose(
        binned_erf_counts(vals, edges, 0.1, bin_mode="auto",
                          bin_window=window).numpy(),
        binned_erf_counts(vals, edges, 0.1, bin_mode="dense").numpy(),
        rtol=1e-4, atol=1e-5)


def test_tune_eval_trial_collapses_donate_variants(tmp_path):
    model = small_smf(sigma_max=0.6)
    cands = [
        {"bin_mode": "dense", "bin_window": None, "chunk_size": None,
         "donate_carry": None},
        {"bin_mode": "dense", "bin_window": None, "chunk_size": None,
         "donate_carry": True},
        {"bin_mode": "dense", "bin_window": None, "chunk_size": None,
         "donate_carry": False},
    ]
    res = tune_model(model, GUESS, sigma_max=0.6,
                     table=TuningTable(str(tmp_path / "t.json")),
                     trial="eval", reps=1, candidates=cands)
    assert res.chosen.get("donate_carry") is None
    assert len(res.candidates) == 1


def test_tune_buckets_max_sizes_one(tmp_path):
    res = tune_buckets(small_smf(n=1000), GUESS, candidates=(1, 2),
                       nsteps=2, reps=1, max_sizes=1,
                       table=TuningTable(str(tmp_path / "t.json")))
    assert res.chosen["buckets"] == [1]


# ------------------------------------------------------------------ #
# Bucket-ladder tuning + scheduler/worker resolution
# ------------------------------------------------------------------ #
def test_tune_buckets_and_scheduler_boot(tmp_path):
    table = TuningTable(str(tmp_path / "t.json"))
    model = small_smf(n=1000)
    res = tune_buckets(model, GUESS, candidates=(1, 2, 4), nsteps=5,
                       reps=1, table=table)
    ladder = res.chosen["buckets"]
    assert ladder[0] == 1 and all(b in (1, 2, 4) for b in ladder)
    assert all(c.get("fits_per_hour") for c in res.candidates)
    sched = FitScheduler(model, buckets="auto", tuning_table=table,
                         start=False)
    assert sched.buckets == tuple(sorted(set(ladder)))
    sched.close(drain=False)
    sched = FitScheduler(model, buckets="auto", tuning_table=table,
                         start=False)
    fut = sched.submit(GUESS, nsteps=5)
    sched.start()
    assert np.all(np.isfinite(fut.result(timeout=60).params))
    sched.close()
    assert tune_buckets(model, GUESS, table=table).warm


def test_scheduler_auto_cold_falls_back_to_defaults(tmp_path):
    sched = FitScheduler(small_smf(n=1000), buckets="auto",
                         tuning_table=str(tmp_path / "none.json"),
                         start=False)
    assert sched.buckets == DEFAULT_BUCKETS
    sched.close(drain=False)
    with pytest.raises(ValueError):
        FitScheduler(small_smf(n=1000), buckets="buckets", start=False)


# ------------------------------------------------------------------ #
# Streaming knobs
# ------------------------------------------------------------------ #
def _table_entry_rows(path):
    entries = TuningTable(path).entries()
    key = [k for k in entries if k.startswith("stream|")][0]
    return entries[key]["knobs"]["chunk_rows"]


def test_stream_auto_resolution_and_tune(tmp_path, monkeypatch):
    from multigrad_tpu_torch.data import StreamingOnePointModel

    table_path = str(tmp_path / "t.json")
    monkeypatch.setenv("MGT_TUNING_TABLE", table_path)
    n = 8192
    aux = make_smf_data(n, device=CPU)
    log_mh = aux.pop("log_halo_masses").numpy()

    def smodel(**kw):
        return StreamingOnePointModel(
            model=SMFModel(aux_data=dict(aux)),
            streams={"log_halo_masses": log_mh}, **kw)

    cold = smodel(chunk_rows="auto", remat_policy="auto")
    assert cold.chunk_rows == n and cold.remat_policy == "dots"
    res = tune_streaming(smodel(chunk_rows=2048), GUESS,
                         table=TuningTable(table_path), trial_steps=1,
                         reps=1)
    assert res.chosen["chunk_rows"] >= 1024
    assert res.candidates[0]["predicted_s"] > 0
    assert _table_entry_rows(table_path) == res.chosen["chunk_rows"]
    tuned = smodel(chunk_rows="auto")
    assert tuned.chunk_rows == res.chosen["chunk_rows"]
    rows, policy = resolve_stream_knobs(
        "SMFModel", n, None, table=table_path, device=CPU)
    assert rows == res.chosen["chunk_rows"] and policy == "dots"
    # The JAX package's cold fallbacks, the same.
    assert jtune.resolve_stream_knobs(
        "SMFModel", 3_000_000, None,
        table=str(tmp_path / "none.json")) == resolve_stream_knobs(
        "SMFModel", 3_000_000, None, table=str(tmp_path / "none.json"))


# ------------------------------------------------------------------ #
# Satellites: regress tuned gate + report tune section
# ------------------------------------------------------------------ #
def test_regress_compare_tuned_and_cli(tmp_path):
    from multigrad_tpu_torch.telemetry import regress

    dossier = {
        "configs": {
            "tuned_defaults": {
                "sigma005": {"handset_s": 1.0, "tuned_s": 0.45,
                             "bin_window": 10},
                "sigma02": {"handset_s": 1.0, "tuned_s": 1.04},
            },
            "smf_1e6_tuned": {"handset_steps_per_sec": 100.0,
                              "tuned_steps_per_sec": 101.0},
        },
        "tunnel_rtt_ms": 0.03,
    }
    path = tmp_path / "BENCH_rX.json"
    path.write_text(json.dumps(dossier))
    results = {r["metric"]: r["status"] for r in regress.compare_tuned(
        regress.load_dossier(str(path)))}
    assert results["tuned_defaults.sigma005.tuned_s"] == "improved"
    assert results["tuned_defaults.sigma02.tuned_s"] == "ok"
    assert results["smf_1e6_tuned.tuned_steps_per_sec"] == "ok"
    assert "tuned_defaults.sigma005.bin_window" not in results
    assert regress.main(["--tuned", str(path)]) == 0
    dossier["configs"]["tuned_defaults"]["sigma02"]["tuned_s"] = 1.8
    bad = tmp_path / "BENCH_rY.json"
    bad.write_text(json.dumps(dossier))
    statuses = {r["metric"]: r["status"] for r in regress.compare_tuned(
        regress.load_dossier(str(bad)))}
    assert statuses["tuned_defaults.sigma02.tuned_s"] == "regressed"
    assert regress.main(["--tuned", str(bad)]) == 1
    assert regress.main(["--tuned", "--warn-only", str(bad)]) == 0
    dossier["configs"]["smf_1e6_tuned"]["tuned_steps_per_sec"] = 50.0
    worse = tmp_path / "BENCH_rZ.json"
    worse.write_text(json.dumps(dossier))
    assert {r["metric"]: r["status"] for r in regress.compare_tuned(
        regress.load_dossier(str(worse)))}[
        "smf_1e6_tuned.tuned_steps_per_sec"] == "regressed"


def test_report_tune_section():
    from multigrad_tpu_torch.telemetry import report

    records = [
        {"event": "run", "t": 0.0, "torch_version": "x", "backend": "cpu"},
        {"event": "tune", "t": 1.0, "key": "model|SMFModel|s|cpu|cpu",
         "scope": "model", "knobs": {"bin_mode": "dense"},
         "predicted_s": 1e-4, "measured_s": 2e-3, "chosen": False},
        {"event": "tune", "t": 1.1, "key": "model|SMFModel|s|cpu|cpu",
         "scope": "model", "knobs": {"bin_mode": "fused",
                                     "bin_window": 10},
         "predicted_s": 9e-5, "measured_s": 1e-3, "chosen": True},
    ]
    summary = report.summarize(records)
    assert summary["tune"]["records"] == 2
    assert summary["tune"]["chosen"][0]["knobs"]["bin_mode"] == "fused"
    rendered = report.render(summary)
    assert "tune:" in rendered and "fused" in rendered


# ------------------------------------------------------------------ #
# CLI
# ------------------------------------------------------------------ #
def test_tune_cli_receipt_and_telemetry(tmp_path, capsys):
    from multigrad_tpu_torch.tune.__main__ import main

    table = str(tmp_path / "t.json")
    telem = str(tmp_path / "tune.jsonl")
    rc = main(["--device", "cpu", "--num-halos", "3000",
               "--trial-steps", "3", "--reps", "1", "--table", table,
               "--telemetry", telem, "--tune-buckets",
               "--bucket-candidates", "1,2", "--bucket-nsteps", "4"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    assert "TUNE OK" in out.out
    assert "TUNE scheduler boots buckets=" in out.err
    tune_recs = [json.loads(line) for line in open(telem)
                 if '"tune"' in line]
    assert any(r.get("chosen") for r in tune_recs)
    keys = TuningTable(table).entries()
    assert len([k for k in keys if k.startswith("model|SMFModel|")]) == 1
    assert len([k for k in keys if k.startswith("buckets|")]) == 1
    rc2 = main(["--device", "cpu", "--num-halos", "3000", "--table",
                table, "--tune-buckets", "--bucket-candidates", "1,2"])
    out2 = capsys.readouterr()
    assert rc2 == 0
    assert "warm=True trials=0" in out2.err


# ------------------------------------------------------------------ #
# Keys and candidates against the JAX package's
# ------------------------------------------------------------------ #
def test_key_shape_helpers():
    assert model_shape_key(1_000_000, 41, 10) == "rows2^20|e41|w10"
    assert model_shape_key(4096) == "rows2^12"
    key = make_key("model", "SMFModel", "rows2^12",
                   backend="cpu", device_kind="TFRT CPU")
    assert key == "model|SMFModel|rows2^12|cpu|tfrt_cpu"
    assert make_key("model", "SMFModel", "rows2^27", backend="cuda",
                    device_kind="NVIDIA H100 80GB HBM3") == \
        "model|SMFModel|rows2^27|cuda|nvidia_h100_80gb_hbm3"
    for n in (1, 2, 3, 1000, 4096, 1_000_000, 100_000_000):
        assert rows_bucket(n) == jtune.rows_bucket(n)
        for edges, window in ((None, None), (41, 10), (11, None)):
            assert model_shape_key(n, edges, window) == \
                jtune.model_shape_key(n, edges, window)
    for args in (("model", "SMFModel", "rows2^12", "cpu", "cpu"),
                 ("stream", "M", "rows2^3", "cuda", "NVIDIA H100"),
                 ("buckets", "SMFModel", "rows2^20")):
        assert make_key(*args) == jtune.make_key(*args)


@pytest.mark.parametrize("kw", [{}, {"sigma_max": 0.6},
                                {"bin_mode": "fused", "sigma_max": 0.3}])
def test_aux_model_key_matches_jax(kw):
    from multigrad_tpu.tune.resolve import aux_model_key as jax_key
    port = aux_model_key("SMFModel", make_smf_data(5000, device=CPU, **kw))
    assert port == jax_key("SMFModel", jsmf.make_smf_data(5000, **kw),
                           backend="cpu", device_kind="cpu")


def test_candidate_lists_match_jax():
    from multigrad_tpu.data import StreamingOnePointModel as JaxStreaming
    from multigrad_tpu_torch.data import StreamingOnePointModel

    n = 1 << 20
    for kw in ({"sigma_max": 0.6}, {"chunk_size": 1 << 18},
               {"bin_mode": "fused", "sigma_max": 0.3}):
        port = model_candidates(small_smf(n, **kw))
        want = jtune.model_candidates(jsmf.SMFModel(
            aux_data=jsmf.make_smf_data(n, **kw)))
        assert port == want
        # On the card: no chunk candidates for the SMF model, whose CUDA
        # kernels stream any N, and no donation.
        card = model_candidates(small_smf(n, **kw), backend="cuda")
        assert {c["chunk_size"] for c in card} == \
            {kw.get("chunk_size")}
        assert [c["bin_mode"] for c in card] == \
            list(dict.fromkeys(c["bin_mode"] for c in want))
        assert all(c["donate_carry"] is None for c in card)
    aux = make_smf_data(n, device=CPU)
    log_mh = aux.pop("log_halo_masses").numpy()
    jaux = jsmf.make_smf_data(n)
    del jaux["log_halo_masses"]
    for use_scan in (False, True):
        port = streaming_candidates(StreamingOnePointModel(
            model=SMFModel(aux_data=dict(aux)),
            streams={"log_halo_masses": log_mh}, chunk_rows=1 << 16),
            use_scan=use_scan)
        want = jtune.streaming_candidates(JaxStreaming(
            model=jsmf.SMFModel(aux_data=dict(jaux)),
            streams={"log_halo_masses": log_mh}, chunk_rows=1 << 16),
            use_scan=use_scan)
        assert port == want
    model = small_smf(1000)
    jmodel = jsmf.SMFModel(aux_data=jsmf.make_smf_data(1000))
    for budget in (None, 10_000, 10 ** 9):
        assert bucket_candidates(model, 200, 2, budget_bytes=budget) == \
            jtune.bucket_candidates(jmodel, 200, 2, budget_bytes=budget)
    with pytest.raises(NotImplementedError, match="item 6"):
        bucket_candidates(model, 200, 2, k_sharded=True)


def test_history_chunk_candidates_stay_on_the_card():
    from multigrad_tpu_torch.models.galhalo_hist import (
        GalhaloHistModel, make_galhalo_hist_data)
    aux = make_galhalo_hist_data(1000, chunk_size=500, sigma_max=0.32,
                                 device=CPU)
    aux["log_halo_masses"] = torch.zeros(1 << 20)    # the rows, cheaply
    model = GalhaloHistModel(aux_data=aux)
    for backend in ("cpu", "cuda"):
        chunks = {c["chunk_size"] for c in model_candidates(
            model, backend=backend)}
        assert chunks == {500, 1 << 18}


# ------------------------------------------------------------------ #
# One table, both packages
# ------------------------------------------------------------------ #
def test_tables_read_across_packages(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    monkeypatch.setenv("MGT_TUNING_TABLE", path)
    aux = make_smf_data(4000, sigma_max=0.6, device=CPU)
    jaux = jsmf.make_smf_data(4000, sigma_max=0.6)
    from multigrad_tpu.tune.resolve import aux_model_key as jax_key
    key = jax_key("SMFModel", jaux, backend="cpu", device_kind="cpu")
    assert key == aux_model_key("SMFModel", aux)
    # Written by the JAX package, resolved by the port...
    jtune.TuningTable(path).record(key, {"bin_mode": "fused",
                                         "bin_window": 11,
                                         "chunk_size": 1024})
    got = SMFModel(aux_data=dict(aux, bin_mode="auto", chunk_size="auto"))
    assert (got.aux_data["bin_mode"], got.aux_data["bin_window"],
            got.aux_data["chunk_size"]) == ("fused", 11, 1024)
    # ...and the other way round, the buckets and stream keys too.
    TuningTable(path).record(key, {"bin_mode": "dense",
                                   "chunk_size": 2048})
    bkey = jtune.make_key("buckets", "SMFModel", "rows2^12", "cpu", "cpu")
    TuningTable(path).record(bkey, {"buckets": [1, 8]})
    want = jsmf.SMFModel(aux_data=dict(jaux, bin_mode="auto",
                                       chunk_size="auto"))
    assert (want.aux_data["bin_mode"], want.aux_data["chunk_size"]) == \
        ("dense", 2048)
    from multigrad_tpu.tune.resolve import resolve_buckets
    from multigrad_tpu_torch.tune.resolve import \
        resolve_buckets as port_resolve_buckets
    assert resolve_buckets(want, table=path) == (1, 8) == \
        port_resolve_buckets(small_smf(), table=path)


def test_tune_cli_resolves_through_its_table(tmp_path, capsys):
    # The resolution proof reads the CLI's --table, not the default table
    # (here cold): a warm fused entry in --table is what "auto" resolves.
    from multigrad_tpu_torch.tune.__main__ import main

    table = str(tmp_path / "t.json")
    key = model_key(small_smf(3000, sigma_max=0.6), sigma_max=0.6)
    TuningTable(table).record(key, {"bin_mode": "fused", "bin_window": 11,
                                    "chunk_size": None})
    rc = main(["--device", "cpu", "--num-halos", "3000", "--table", table])
    out = capsys.readouterr()
    assert rc == 0 and "TUNE OK" in out.out, out.err
    assert "warm=True trials=0" in out.err
    assert "'bin_mode': 'fused'" in out.err
