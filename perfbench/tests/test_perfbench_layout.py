"""``BENCHMARK.json`` and the files it names: every configuration, traffic
mix, limit and per-layer metric is found by name and is valid."""
import json
import math
import os
import re

import pytest

from perfbench.core.registry import Benchmark

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token")


@pytest.fixture(scope="module")
def bench():
    return Benchmark(REPO)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_check_fits_in_its_budget(bench):
    """A full check of 24 cells at this length fits its 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench.spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43_200


def test_names_are_unique_and_well_formed(bench):
    spec = bench.spec
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics_are_well_formed(bench, group):
    e2e = {m["name"] for m in bench.spec["end_to_end"]}
    for m in bench.spec[group]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if group == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert line(m["layer"]) and m["moves"] in e2e
            assert os.path.exists(os.path.join(
                bench.dir, "metrics", f"{m['name']}.py"))
            assert callable(bench.module("metrics", m["name"]).read)
    assert "setup_s" in e2e


def test_every_cell_reports_enough(bench):
    for w in bench.spec["workloads"]:
        e2e = [m["name"] for m in bench.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = bench.per_layer(w["name"])
        assert layer, w["name"]
        for m in layer:       # each moves a metric the cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_configs_are_found_and_valid(bench):
    for c in bench.spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/")
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        config = bench.config(c["name"])
        assert config["reduced"] == c["reduced"]
        for kind in ("programs", "reference", "costs"):
            assert os.path.exists(os.path.join(
                bench.dir, kind, f"{config['model']}.py")), kind
    files = [c["file"] for c in bench.spec["configs"]]
    assert len(files) == len(set(files))


def test_cells_are_found_and_valid(bench):
    used = set()
    for w in bench.spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert os.path.exists(os.path.join(
            bench.dir, "drivers", f"{traffic['driver']}.py"))
        limits = bench.limits(w["name"])
        assert limits and all(v > 0 and math.isfinite(v)
                              for v in limits.values())
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in {
            (o["config"], o["traffic"]) for o in bench.spec["workloads"]
            if o is not w}
    assert used == {c["name"] for c in bench.spec["configs"]}
    four = sum(w["chips"] == 4 for w in bench.spec["workloads"])
    assert four <= max(1, len(bench.spec["workloads"]) // 4)


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(os.path.join(REPO, "perfbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
            assert len(rel) <= 200


def test_limits_are_json_numbers(bench):
    for w in bench.spec["workloads"]:
        with open(os.path.join(bench.dir, "limits",
                               f"{w['name']}.json")) as f:
            limits = json.load(f)
        assert set(limits) <= {"step_gap", "step_gap_median", "loss_gap"}


#: The sizes and cuts that the rehearsals were tuned at, file by file.  A
#: record to hold the files to: a size retuned on purpose is retuned here
#: too, and a new model or driver needs no entry.
REHEARSED = {
    "smf": ("SIZES", {"num_halos": 20_000}),
    "hist": ("SIZES", {"num_halos": 20_000, "chunk_size": 5_000}),
    "adam": ("CUT", {"nsteps": 12, "warmup_steps": 1}),
    "serve_closed": ("CUT", {"tenants": 8, "buckets": [1, 4],
                             "warmup_buckets": [4], "nsteps": 10,
                             "batch_window_s": 0.0}),
}


def test_every_model_and_driver_has_its_rehearsal(bench):
    for c in bench.spec["configs"]:
        model = bench.module("rehearsal", bench.config(c["name"])["model"])
        assert isinstance(model.SIZES, dict) and model.SIZES, c["name"]
        assert callable(model.half), c["name"]
    for w in bench.spec["workloads"]:
        driver = bench.traffic(w["traffic"])["driver"]
        cut = bench.module("rehearsal", driver).CUT
        assert isinstance(cut, dict) and cut, driver


def test_rehearsals_keep_their_sizes(bench):
    """The rehearsal files read the sizes the rehearsals were tuned at."""
    for name, (key, want) in REHEARSED.items():
        assert getattr(bench.module("rehearsal", name), key) == want, name
