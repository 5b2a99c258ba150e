"""The harness is driven by data: a cell, a configuration, a traffic mix
and a per-layer metric added as new files and entries only are found by
name and run; and BENCHMARK.json's names and units keep to their
characters."""

import json
import re

from _tiny import OFF, REPO, make_root, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (REPO / "perfbench/traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "perfbench/limits" / f"{w['name']}.json").exists()
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert (REPO / "perfbench/metrics" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists() and c["file"].startswith(
            "perfbench/")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_new_files_only_make_a_new_cell(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = make_root(tmp_path)
    # A further mix, cell and per-layer metric: files and entries only.
    mix = json.loads((root / "perfbench/traffic/tiny-off.json").read_text())
    mix.update(batch=3, pool=1)
    (root / "perfbench/traffic/tiny-b3.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/calls_traced.b3.py").write_text(
        "def read(ctx):\n    return float(len(ctx.run.calls))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.b3", "config": "tiny",
                               "traffic": "tiny-b3", "chips": 1,
                               "why": "added by files"})
    bench["end_to_end"][0]["workloads"].append("tiny.b3")
    bench["per_layer"].append({
        "name": "calls_traced.b3", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "facade api.Yolov4.predict_batch",
        "moves": "infer_img_per_s", "workloads": ["tiny.b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = run(root, "tiny.b3")
    assert set(plain["metrics"]) == {"infer_img_per_s", "setup_s"}
    assert plain["attempted"] % 3 == 0
    traced = run(root, "tiny.b3", trace=True)
    assert traced["metrics"]["calls_traced.b3"]["value"] == 3.0
    assert list(traced)[-1] == "checks"
    # The tiny cell of the same configuration is untouched by the new one.
    assert set(run(root, OFF)["metrics"]) == {"infer_img_per_s", "setup_s"}
