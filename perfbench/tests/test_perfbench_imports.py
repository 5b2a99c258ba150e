"""Nothing the benchmark runs loads JAX, jaxlib or the JAX package
``yolov4tpu`` (top-level names compared whole: the port's own name begins
with ``yolov4tpu``), and the reference loads nothing of the program."""

import json
import subprocess
import sys
import textwrap

from _tiny import OFF, REPO, TRAIN, make_root

from perfbench.harness import env


def _python(code: str, tmp_path):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env={**__import__("os").environ,
                                        "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yolov4tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlibx", sys)
    assert "yolov4tpu" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "yolov4tpu.api", sys)
    assert env.forbidden_modules() == ["yolov4tpu"]


def test_a_dry_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    mods = _python(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        sys.path.insert(0, {str(REPO / 'perfbench/tests')!r})
        from _tiny import run
        from pathlib import Path
        run(Path({str(root)!r}), {OFF!r}, trace=True)
        run(Path({str(root)!r}), {TRAIN!r})
        print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
        """, tmp_path)
    assert "yolov4tpu_torch" in mods and "perfbench" in mods
    assert not set(mods) & {"jax", "jaxlib", "flax", "yolov4tpu"}


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    mods = _python(f"""
        import json, sys, pkgutil, importlib
        sys.path.insert(0, {str(REPO)!r})
        import perfbench.reference as ref
        for m in pkgutil.iter_modules(ref.__path__):
            importlib.import_module('perfbench.reference.' + m.name)
        print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
        """, tmp_path)
    assert not set(mods) & {"yolov4tpu_torch", "yolov4tpu", "jax", "jaxlib"}


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "yolov4-416-coco80.offline-b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env={**__import__("os").environ, "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
