"""The port's command lines (``yolov4tpu_torch.examples``, ``tools.video``)
on the CPU, each called in-process through ``main(argv)`` with
``--device cpu``:

  - eval, at 64 px on an ``.npz`` written by ``save_model``, against the JAX
    package's ``examples/eval.py`` run on the same files: ground-truth
    files byte-equal, prediction files within 1e-3 per box with equal
    classes and counts, the same mAP line;
  - inference and export_serving (full depth, 416^2: the scripts take no
    size) against the port's facade on the same synthetic darknet weights;
  - train at 64 px from the seeded random init: its checkpoint and final
    file bit-equal to a facade ``fit`` with the same config and seeded
    generators; every flag reaching the config; ``--devices 2`` without a
    process group of two ranks raising the port's mesh error;
  - every script raising without CUDA unless given ``--device cpu``;
  - the video tool on a short clip.

The scripts build full-depth models (a ``.npz`` carries no config), so the
weights are the well-conditioned full-depth ones of ``_torch_parity`` with
the head biases calibrated so the model detects.
"""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from _torch_parity import images, no_cluster, well_conditioned  # noqa: F401
from yolov4tpu_torch import serving
from yolov4tpu_torch import weights as tweights
from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.callbacks import CheckpointCallback
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data.pipeline import DataGenerator
from yolov4tpu_torch.examples import eval as teval
from yolov4tpu_torch.examples import export_serving as texport
from yolov4tpu_torch.examples import inference as tinference
from yolov4tpu_torch.examples import train as ttrain
from yolov4tpu_torch.models import network
from yolov4tpu_torch.tools import video as tvideo
from yolov4tpu_torch.utils.io import read_annotation_lines

REPO = pathlib.Path(__file__).resolve().parents[1]
C = 3
FULL = (1, 2, 8, 8, 4)
# Raw JPEG sizes (h, w): wide, tall and square.
SIZES = [(80, 96), (120, 64), (64, 64), (96, 150)]


def busy_params(side: int):
    """Full-depth well-conditioned (params, state) on the CPU with the head
    biases calibrated so ~30 boxes an image clear 0.3 at ``side``^2."""
    params, state = network.params_from_jax(*well_conditioned(C, 0, FULL))
    imgs = images(0, 2, side).astype(np.float32) / 255.0
    with torch.inference_mode():
        raws = network.apply_folded(network.fold_bn(params, state),
                                    torch.from_numpy(imgs), C)
    params, _ = tweights.calibrate_detection_density(
        params, [r.numpy() for r in raws], C, target_per_image=30.0)
    return params, state


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """classes.txt, imgs/ with four JPEGs and anno.txt (two boxes each)."""
    import cv2
    d = tmp_path_factory.mktemp("examples")
    (d / "classes.txt").write_text("a\nb\nc\n")
    (d / "imgs").mkdir()
    lines = []
    for i, (h, w) in enumerate(SIZES):
        cv2.imwrite(str(d / "imgs" / f"e{i}.jpg"),
                    cv2.resize(images(i, 1)[0], (w, h)))
        lines.append(f"e{i}.jpg 4,6,{w // 2},{h // 2},{i % C} "
                     f"{w // 3},{h // 4},{w - 3},{h - 2},{(i + 1) % C}\n")
    (d / "anno.txt").write_text("".join(lines))
    return d


@pytest.fixture(scope="module")
def weights416(data):
    """A darknet .weights file of busy full-depth 3-class weights at 416."""
    path = data / "busy416.weights"
    tweights.save_darknet_weights(*busy_params(416), str(path))
    return str(path)


def _args(**kw):
    out = []
    for key, value in kw.items():
        out += [f"--{key.replace('_', '-')}", str(value)]
    return out


# ---------------------------------------------------------------------------
# eval: held to the JAX package's script
# ---------------------------------------------------------------------------

def _jax_eval_script():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_example", REPO / "examples" / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_preds(path):
    rows = [line.split() for line in path.read_text().splitlines()]
    return ([r[0] for r in rows], np.array([[float(v) for v in r[1:]]
                                            for r in rows]).reshape(-1, 5))


def test_eval_matches_jax_script(data, tmp_path, capsys, monkeypatch):
    facade = Yolov4(None, str(data / "classes.txt"),
                    config=YoloConfig(img_size=(64, 64, 3)), device="cpu")
    facade.sync_params(*busy_params(64))
    npz = str(tmp_path / "busy64.npz")
    facade.save_model(npz)
    # Ground truth: half of each image's detections (rounded to pixels)
    # and one box the model does not find, so the mAP is neither 0 nor 1.
    jpegs = [str(data / "imgs" / f"e{i}.jpg") for i in range(len(SIZES))]
    lines = []
    for path, df in facade.predict_paths(jpegs, bs=2):
        boxes = [f"{int(r.x1)},{int(r.y1)},{int(r.x2)},{int(r.y2)},"
                 f"{facade.class_names.index(r.class_name)}"
                 for r in df.iloc[::2].itertuples()]
        boxes.append("1,2,30,40,1")
        lines.append(pathlib.Path(path).name + " " + " ".join(boxes) + "\n")
    anno = tmp_path / "anno.txt"
    anno.write_text("".join(lines))
    argv = _args(weights=npz, anno=anno, classes=data / "classes.txt",
                 imgdir=data / "imgs", bs=2, img_size=64) + ["--no-plot"]

    scores = teval.main(argv + ["--outdir", str(tmp_path / "port"),
                                "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv, "--outdir",
                                      str(tmp_path / "jax")])
    _jax_eval_script().main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]

    port, jax = json.loads(port_line), json.loads(jax_line)
    assert port == jax
    assert port["mAP"] == scores["mAP"] and 0 < port["mAP"] < 1
    for i, (h, w) in enumerate(SIZES):
        gt = f"ground_truth/e{i}.txt"
        assert ((tmp_path / "port" / gt).read_bytes()
                == (tmp_path / "jax" / gt).read_bytes())
        names, got = _read_preds(tmp_path / "port" / "pred_result" /
                                 f"e{i}.txt")
        want_names, want = _read_preds(tmp_path / "jax" / "pred_result" /
                                       f"e{i}.txt")
        assert names == want_names and len(names) > 0
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-3)
        size = np.array([w, h, w, h])
        assert (np.abs(got[:, 1:] - want[:, 1:]) <= 1e-3 * size).all()
    assert ((tmp_path / "port" / "result" / "output.txt").read_bytes()
            == (tmp_path / "jax" / "result" / "output.txt").read_bytes())


# ---------------------------------------------------------------------------
# inference and export_serving: held to the port's facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inference_prints_the_facades_table(data, weights416, capsys, dtype):
    image = str(data / "imgs" / "e3.jpg")
    argv = _args(weights=weights416, image=image,
                 classes=data / "classes.txt", device="cpu")
    got = tinference.main(argv + (["--bf16"] if dtype == "bfloat16" else []))
    printed = capsys.readouterr().out
    facade = Yolov4(weights416, str(data / "classes.txt"),
                    config=YoloConfig(compute_dtype=dtype), device="cpu")
    want = facade.predict(image, plot_img=False)
    assert len(want) > 0
    assert printed.endswith(want.to_string() + "\n")
    assert got.equals(want)


def test_export_serving_export_then_run(data, weights416, tmp_path, capsys):
    import cv2
    artifact = str(tmp_path / "busy_b1.pt2")
    image = str(data / "imgs" / "e0.jpg")
    texport.main(["export", *_args(weights=weights416,
                                   classes=data / "classes.txt",
                                   out=artifact, batch=1, device="cpu")])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        f"exported {artifact} (")
    texport.main(["run", *_args(artifact=artifact, image=image,
                                device="cpu")])
    printed = capsys.readouterr().out.strip().splitlines()

    detect = serving.load_detector(artifact, device="cpu")
    assert detect.input_shape == (1, 416, 416, 3)
    x = (cv2.resize(cv2.imread(image)[:, :, ::-1], (416, 416))
         .astype(np.float32)[None] / 255.0)
    boxes, scores, classes, valid = [o.numpy() for o in detect(x)]
    n = int(valid[0])
    assert n > 0
    assert printed == [f"{n} detections"] + [
        f"  class={int(c)} score={s:.3f} box={np.round(b, 3)}"
        for b, s, c in zip(boxes[0, :n], scores[0, :n], classes[0, :n])]
    # The artifact serves the live facade's pipeline.
    facade = Yolov4(weights416, str(data / "classes.txt"), device="cpu")
    live = [o.numpy() for o in facade.predict_batch(x)]
    np.testing.assert_array_equal(valid, live[3])
    np.testing.assert_array_equal(classes, live[2])
    np.testing.assert_allclose(scores, live[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes, live[0], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# train: held to the facade's fit
# ---------------------------------------------------------------------------

def _train_argv(data, tmp_path, *extra):
    """The script's arguments over the first two images: one step of b2."""
    anno = tmp_path / "train.txt"
    anno.write_text("".join((data / "anno.txt").read_text()
                            .splitlines(keepends=True)[:2]))
    return [*_args(anno=anno, classes=data / "classes.txt",
                   imgdir=data / "imgs", img_size=64, batch=2,
                   out=tmp_path / "final.npz", device="cpu"), *extra]


def _assert_npz_equal(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for key in fa.files:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def test_train_matches_facade_fit(data, tmp_path):
    ckpt = tmp_path / "ckpts"
    model = ttrain.main(_train_argv(data, tmp_path, "--epochs", "1",
                                    "--ckpt", str(ckpt)))
    cfg = YoloConfig(img_size=(64, 64, 3), batch_size=2)
    assert model.config == cfg
    assert sorted(p.name for p in ckpt.iterdir()) == ["epoch0.npz"]

    classes = str(data / "classes.txt")
    ref = Yolov4(None, classes, config=cfg, device="cpu")
    gen = DataGenerator(read_annotation_lines(str(tmp_path / "train.txt")),
                        classes, str(data / "imgs"), config=cfg, seed=0)
    ref.fit(gen, epochs=1, callbacks=[
        CheckpointCallback(str(tmp_path / "ref") + "/epoch{epoch}.npz")])
    ref.save_model(str(tmp_path / "ref_final.npz"))
    assert len(ref.trainer().history) == 1
    _assert_npz_equal(ckpt / "epoch0.npz", tmp_path / "ref" / "epoch0.npz")
    _assert_npz_equal(tmp_path / "final.npz", tmp_path / "ref_final.npz")


def test_train_flags_reach_the_config(data, tmp_path):
    """Every flag, at zero epochs (no step), into the facade's config and
    the written file."""
    model = ttrain.main(_train_argv(
        data, tmp_path, "--epochs", "0", "--val-anno", str(data / "anno.txt"),
        "--bf16", "--mosaic", "--hflip", "--jitter", "--letterbox",
        "--multi-scale", "64", "96", "--accum", "2", "--smooth", "0.1",
        "--encode-on-device", "--no-bn-stats-grad", "--pallas-wgrad"))
    assert model.config == YoloConfig(
        img_size=(64, 64, 3), batch_size=2, compute_dtype="bfloat16",
        use_mosaic=True, label_smoothing=0.1, use_hflip=True,
        use_color_jitter=True, letterbox=True, multi_scale=(64, 96),
        grad_accum_steps=2, encode_on_device=True, bn_stats_gradient=False,
        pallas_wgrad=True)
    assert model.device.type == "cpu"
    assert (tmp_path / "final.npz").exists()


def test_train_devices_without_a_group_of_that_size_raises(data, tmp_path,
                                                          no_cluster):
    with pytest.warns(UserWarning, match="continuing single-process"), \
            pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ttrain.main(_train_argv(data, tmp_path, "--epochs", "1",
                                "--devices", "2"))
    assert not (tmp_path / "final.npz").exists()


# ---------------------------------------------------------------------------
# The card by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script", ["inference", "eval", "train", "export",
                                    "run", "video"])
def test_scripts_default_to_cuda_and_raise_without_it(data, script):
    assert not torch.cuda.is_available()
    f = str(data / "anno.txt")
    main, argv = {
        "inference": (tinference.main, ["--weights", f, "--image", f]),
        "eval": (teval.main, ["--weights", f, "--anno", f, "--classes", f,
                              "--imgdir", f]),
        "train": (ttrain.main, ["--anno", f, "--classes", f, "--imgdir", f]),
        "export": (texport.main, ["export", "--weights", f, "--out", f]),
        "run": (texport.main, ["run", "--artifact", f, "--image", f]),
        "video": (tvideo.main, ["--weights", f, "--classes", f, "--input", f,
                                "--output", f]),
    }[script]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([*argv, "--device", "cuda"])


@pytest.mark.parametrize("name", ["inference", "eval", "train",
                                  "export_serving"])
def test_scripts_run_as_modules(name):
    """``python -m yolov4tpu_torch.examples.<name>`` from the repository's
    root, with no path edit: the help names ``--device``."""
    import subprocess
    argv = [sys.executable, "-m", f"yolov4tpu_torch.examples.{name}"]
    if name == "export_serving":
        argv.append("export")
    proc = subprocess.run([*argv, "--help"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout


# ---------------------------------------------------------------------------
# tools/video on the CPU
# ---------------------------------------------------------------------------

def test_video_tool_on_the_cpu(data, weights416, tmp_path, capsys):
    import cv2
    clip, out = str(tmp_path / "clip.mp4"), str(tmp_path / "out.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (96, 64))
    assert writer.isOpened()
    for i in range(3):
        writer.write(images(i, 1, 96)[0][:64])
    writer.release()
    n = tvideo.main(_args(weights=weights416,
                          classes=data / "classes.txt", input=clip,
                          output=out, bs=2, device="cpu"))
    assert n == 3
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"wrote 3 annotated frames to {out}")
    cap = cv2.VideoCapture(out)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame.shape)
    cap.release()
    assert frames == [(64, 96, 3)] * 3
