"""A temporary checkout for the benchmark's CPU tests: BENCHMARK.json and
perfbench/ copied, plus a tiny configuration (64 px, one residual unit a
stage) and tiny inference and training cells, added as files and entries
only, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
OFF, TRAIN = "tiny.off", "tiny.train"


def make_root(tmp: Path, side: int = 64, dtype: str = "bfloat16",
              limits=None) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "perfbench/configs/yolov4-416-coco80.json")
                     .read_text())
    cfg.update(name="tiny", img_size=side, csp_repeats=[1, 1, 1, 1, 1],
               compute_dtype=dtype)
    (root / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    off = json.loads((REPO / "perfbench/traffic/offline-b64.json")
                     .read_text())
    off.update(batch=2, pool=2, warmup_calls=1, density=20, check_calls=2,
               ref_block=2, trace_calls=3)
    (root / "perfbench/traffic/tiny-off.json").write_text(json.dumps(off))
    trn = json.loads((REPO / "perfbench/traffic/train-b32.json").read_text())
    trn.update(batch=4, images=16, image_hw=[48, 64], trace_steps=3,
               pallas_wgrad=False)
    (root / "perfbench/traffic/tiny-train.json").write_text(json.dumps(trn))
    bench["workloads"] += [
        {"name": OFF, "config": "tiny", "traffic": "tiny-off", "chips": 1,
         "why": "CPU tests"},
        {"name": TRAIN, "config": "tiny", "traffic": "tiny-train",
         "chips": 1, "why": "CPU tests"}]
    twin = {"yolov4-416-coco80.offline-b64": OFF,
            "yolov4-608-coco80.train-b32": TRAIN}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [twin[w] for w in list(m["workloads"])
                               if w in twin]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, lim in (limits or {}).items():
        (root / f"perfbench/limits/{name}.json").write_text(json.dumps(lim))
    return root


def run(root: Path, cell: str, seed: int = 2 ** 31 + 7, trace=False,
        variants=(), seconds: float = 0.5, every=False):
    """One run of a cell of ``root`` on the CPU, past run.py's look for a
    card."""
    from perfbench.harness import env, manifest, runner
    env.prepare()
    torch.set_num_threads(2)
    return runner.run_cell(manifest.cell(cell, root), seed, seconds, trace,
                           "cpu", 0, variants=variants, all_checks=every)


def readings(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}
