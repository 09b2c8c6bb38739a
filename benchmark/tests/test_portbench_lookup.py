"""Every part that BENCHMARK.json names is found by its name, and a part
added as a new file is found without an edit to any file there."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import harness


def test_each_named_part_is_found():
    bench = harness.spec()
    for c in bench["configs"]:
        cfg = harness.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in bench["workloads"]:
        mix = harness.traffic(w["traffic"])
        assert hasattr(harness.loop(mix["loop"]), "run")
        assert harness.cell(w["name"]).get("limits"), w["name"]
    for m in bench["per_layer"]:
        assert callable(harness.metric(m["name"]).read)
    for layer in ("march", "shade", "segments", "composite"):
        assert harness.layer_patterns(layer)


def test_new_files_are_found_without_edits(tmp_path):
    from benchmark.tests import tiny

    dst = tiny.make(tmp_path)
    before = {p: p.read_bytes() for p in (dst / "benchmark").rglob("*") if p.is_file()}
    (dst / "benchmark/configs/throwaway.json").write_text(json.dumps({"name": "throwaway"}))
    (dst / "benchmark/traffic/throwaway.json").write_text(json.dumps({"loop": "viewer"}))
    (dst / "benchmark/metrics/throwaway.layer.py").write_text(
        "def read(record, work):\n    return record.get('x')\n")
    (dst / "benchmark/layers/throwaway").mkdir()
    (dst / "benchmark/layers/throwaway/k.txt").write_text("throwaway_kernel  # a comment\n")
    code = ("from benchmark import harness; "
            "assert harness.config('throwaway') == {'name': 'throwaway'}; "
            "assert harness.loop(harness.traffic('throwaway')['loop']).run; "
            "assert harness.metric('throwaway.layer').read({'x': 2.5}, {}) == 2.5; "
            "assert harness.metric('idle_share.throwaway') is harness.metric('idle_share.viewer'); "
            "assert [p.pattern for p in harness.layer_patterns('throwaway')] "
            "== ['throwaway_kernel']; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for p, data in before.items():
        assert p.read_bytes() == data, p
