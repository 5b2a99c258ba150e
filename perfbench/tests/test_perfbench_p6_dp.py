"""Dry runs on the CPU, at a size a test holds: YOLOv4-P6's cell at 128
px with one Bottleneck a stage (the float8 control read beside the
program), and the data-parallel training loop (``loops/train_dp.py``,
which no cell runs yet) over four gloo ranks of batch 2 at 64 px, with
train-b32's limits and per-layer metrics but those that count one card's
work.  Each is added to a copy of the benchmark as files and entries
only."""

import json

from _tiny import REPO, make_root, readings, run

P6, DP = "tinyp6.off", "tiny.dp"


def add_cells(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "perfbench/configs/yolov4-p6-1280-coco80.json")
                     .read_text())
    cfg.update(name="tinyp6", img_size=128, csp_repeats=[1] * 7)
    (root / "perfbench/configs/tinyp6.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tinyp6", "source": "test",
                             "file": "perfbench/configs/tinyp6.json",
                             "reduced": [], "why": "CPU tests"})
    off = json.loads((REPO / "perfbench/traffic/offline-b16.json")
                     .read_text())
    off.update(batch=2, pool=2, warmup_calls=1, calibrate_images=2,
               density=20, check_calls=2, ref_block=2, trace_calls=3)
    (root / "perfbench/traffic/tiny-p6.json").write_text(json.dumps(off))
    dp = json.loads((REPO / "perfbench/traffic/train-dp4-b32.json")
                    .read_text())
    dp.update(batch=2, images=32, image_hw=[48, 64], trace_steps=3,
              pallas_wgrad=False)
    (root / "perfbench/traffic/tiny-dp.json").write_text(json.dumps(dp))
    bench["workloads"] += [
        {"name": P6, "config": "tinyp6", "traffic": "tiny-p6", "chips": 1,
         "why": "CPU tests"},
        {"name": DP, "config": "tiny", "traffic": "tiny-dp", "chips": 1,
         "why": "CPU tests"}]
    twin = {"yolov4-p6-1280-coco80.offline-b16": P6,
            "yolov4-608-coco80.train-b32": DP}
    one_card = ("mfu.train", "wgrad_3x3_roofline.train")  # would read 4x
    for m in bench["end_to_end"] + bench["per_layer"]:
        for w in list(m.get("workloads", ())):
            if w in twin and not (twin[w] == DP and m["name"] in one_card):
                m["workloads"].append(twin[w])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, name in twin.items():
        (root / f"perfbench/limits/{name}.json").write_text(
            (REPO / f"perfbench/limits/{cell}.json").read_text())
    return root


def test_p6_cell_and_its_control(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = add_cells(make_root(tmp_path, side=128))
    out = run(root, P6, 5, trace=True, variants=("control",), every=True)
    prog, ctrl = readings(out), out["variants"]["control"]
    limit = out["checks"]["grid_ratio"]["limit"]
    assert prog["grid_ratio"] <= limit < ctrl["grid_ratio"]
    assert prog["det_gap"] <= out["checks"]["det_gap"]["limit"]
    assert {"mfu_p6.infer", "merge_epilogue_roofline.infer"} <= set(
        out["metrics"])
    assert "mfu.infer" not in out["metrics"]


def test_dp_cell_over_four_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = add_cells(make_root(tmp_path, dtype="float32"))
    out = run(root, DP, 7, trace=True)
    assert out["correct"] and out["device"]["count"] == 4
    assert out["attempted"] % 8 == 0
    assert readings(out)["grad_total"] < 0.05
    assert {"idle_share.train", "ingest_wait_share.train"} <= set(
        out["metrics"])
    assert "mfu.train" not in out["metrics"]
