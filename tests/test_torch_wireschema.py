"""The port's wire-schema pass (``multigrad_tpu_torch.analysis
.wireschema``, a copy of the JAX package's) and its own manifest,
``multigrad_tpu_torch/analysis/protocol.json``, on the CPU.

* The JAX suite's seeded fixtures under ``tests/fixtures/wire/``, read
  in place, give the same findings through both packages' modules.
* The port's ``serve/`` is clean against its own manifest, which is the
  extraction byte for byte (``--emit-protocol`` writes it).
* The static proof that a JAX router can drive a port worker: the port's
  manifest differs from the JAX package's (read in place) by exactly one
  key, ``messages.ready.writer.buckets``, added — the port's READY
  handshake names the worker's bucket ladder — and the JAX package's
  ``ready`` message has no reader, so a JAX router ignores it.  Any other
  difference fails.
"""
import json
import os
import shutil

import pytest

from multigrad_tpu_torch.analysis.findings import ERROR
from multigrad_tpu_torch.analysis.lint import main
from multigrad_tpu_torch.analysis.wireschema import (DEFAULT_MANIFEST_PATH,
                                                     WIRE_CHECK_IDS,
                                                     analyze_wire,
                                                     diff_schema,
                                                     dump_schema,
                                                     extract_schema,
                                                     protocol_markdown)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "wire")
JAX_MANIFEST = os.path.join(REPO_ROOT, "multigrad_tpu", "analysis",
                            "protocol.json")


@pytest.fixture(scope="module")
def schema():
    return extract_schema().schema


def test_fixtures_give_the_jax_package_s_findings():
    from multigrad_tpu.analysis.wireschema import analyze_wire as jax_wire
    checks = ("wire-key-asymmetry", "wire-reader-splat")
    got = [f.to_dict() for f in analyze_wire(root=FIXTURES, checks=checks)]
    want = [f.to_dict() for f in jax_wire(root=FIXTURES, checks=checks)]
    assert got == want
    assert {f["check"] for f in got} == set(checks)


def test_registry_is_the_jax_package_s():
    from multigrad_tpu.analysis.wireschema import \
        WIRE_CHECK_IDS as JAX_IDS
    assert WIRE_CHECK_IDS == JAX_IDS


def test_port_tree_clean_against_its_own_manifest():
    assert DEFAULT_MANIFEST_PATH == os.path.join(
        REPO_ROOT, "multigrad_tpu_torch", "analysis", "protocol.json")
    findings = analyze_wire()
    assert findings == [], [(f.check, f.where) for f in findings]


def test_committed_manifest_is_the_extraction(schema):
    with open(DEFAULT_MANIFEST_PATH, encoding="utf-8") as f:
        assert f.read() == dump_schema(schema)


def test_manifest_differs_from_the_jax_package_s_by_one_key(schema):
    with open(JAX_MANIFEST, encoding="utf-8") as f:
        jax_manifest = json.load(f)
    diffs = diff_schema(jax_manifest, schema)
    assert len(diffs) == 1, diffs
    assert diffs[0].startswith("messages.ready.writer.buckets: added")
    # The JAX router reads no key of the handshake.
    assert jax_manifest["messages"]["ready"]["reader"] is None
    assert schema["messages"]["ready"]["reader"] is None


def test_port_serve_scan_sees_the_protocol(schema):
    assert {"config", "qos", "result", "shed"} <= set(schema["codecs"])
    assert {"submit", "result", "ready"} <= set(schema["messages"])
    markdown = protocol_markdown(schema)
    assert "multigrad_tpu_torch/analysis/" in markdown
    assert "`ready`" in markdown


def test_codec_key_rename_fails_drift_gate(tmp_path):
    scratch = tmp_path / "serve"
    shutil.copytree(os.path.join(REPO_ROOT, "multigrad_tpu_torch",
                                 "serve"), scratch,
                    ignore=shutil.ignore_patterns("__pycache__"))
    wire = scratch / "wire.py"
    src = wire.read_text()
    assert '"loss":' in src
    wire.write_text(src.replace('"loss":', '"final_loss":'))
    findings = analyze_wire(model=extract_schema(root=str(tmp_path)),
                            checks=("wire-manifest-drift",))
    drift = sorted(f.where for f in findings)
    assert any("codecs.result.writer.final_loss" in w for w in drift)
    assert any("codecs.result.writer.loss" in w for w in drift)
    assert all(f.severity == ERROR for f in findings)


def test_lint_emit_protocol_round_trip(tmp_path, capsys):
    out_path = tmp_path / "protocol.json"
    assert main(["--targets", "wire", "--emit-protocol", str(out_path),
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    with open(DEFAULT_MANIFEST_PATH, encoding="utf-8") as f:
        assert out_path.read_text() == f.read()
    # The JAX package's manifest is drift to the port.
    assert main(["--targets", "wire", "--manifest", JAX_MANIFEST,
                 "--device", "cpu"]) == 1
    assert "messages.ready.writer.buckets" in capsys.readouterr().out
