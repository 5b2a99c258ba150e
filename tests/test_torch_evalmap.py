"""The port's mAP pipeline (evalmap), VOC-XML converter (tools.xml_to_txt)
and streaming helper (utils.stream) against the JAX package's copies: the
same files byte for byte, the same scores, the same cancellation contract.
Pure Python, no model."""

import os
import threading
import time

import numpy as np
import pytest

from yolov4tpu import evalmap as jevalmap
from yolov4tpu.tools.xml_to_txt import convert as jax_convert
from yolov4tpu_torch import evalmap
from yolov4tpu_torch.tools import xml_to_txt
from yolov4tpu_torch.utils.io import parse_annotation_line, read_txt_to_list
from yolov4tpu_torch.utils.stream import threaded_map

CLASSES = ["cat", "dog", "bird"]


def _annotation(rng, n_images=6):
    """Annotation lines "dir/imgN.jpg x1,y1,x2,y2,cls ..." with 1-5 boxes."""
    lines = []
    for i in range(n_images):
        objs = []
        for _ in range(int(rng.integers(1, 6))):
            x1, y1 = rng.integers(0, 300, 2)
            w, h = rng.integers(10, 120, 2)
            objs.append(f"{x1},{y1},{x1 + w},{y1 + h},"
                        f"{int(rng.integers(0, len(CLASSES)))}")
        lines.append(f"imgs/img{i}.jpg " + " ".join(objs) + "\n")
    return lines


def _predictions(rng, gt_dir, pred_dir):
    """Per-image prediction txts from the GT files: jittered true boxes
    (some lost, some duplicated, some with the wrong class) and a false
    positive, with float confidences as export_prediction writes them."""
    os.makedirs(pred_dir, exist_ok=True)
    for name in sorted(os.listdir(gt_dir)):
        out = []
        for line in read_txt_to_list(os.path.join(gt_dir, name)):
            cls, *box = line.split()
            box = np.array([float(v) for v in box]) + rng.normal(0, 4, 4)
            if rng.uniform() < 0.2:
                continue
            if rng.uniform() < 0.15:
                cls = CLASSES[int(rng.integers(0, len(CLASSES)))]
            for _ in range(1 + int(rng.uniform() < 0.2)):
                conf = np.float32(rng.uniform(0.05, 1))
                out.append(f"{cls} {conf} {box[0]} {box[1]} {box[2]} "
                           f"{box[3]}\n")
        out.append(f"dog {np.float32(rng.uniform(0.05, 1))} 1.5 2.5 30.0 "
                   "40.0\n")
        with open(os.path.join(pred_dir, name), "w") as f:
            f.writelines(out)


def _files(folder):
    return {p.name: p.read_bytes() for p in sorted(folder.iterdir())
            if p.is_file()}


@pytest.fixture()
def gt_pred(rng, tmp_path):
    anno = tmp_path / "anno.txt"
    anno.write_text("".join(_annotation(rng)))
    evalmap.export_gt(str(anno), str(tmp_path / "gt"), CLASSES)
    jevalmap.export_gt(str(anno), str(tmp_path / "gt_jax"), CLASSES)
    _predictions(rng, str(tmp_path / "gt"), str(tmp_path / "pred"))
    return tmp_path, anno


def test_export_gt_matches_jax(gt_pred):
    tmp, anno = gt_pred
    got, want = _files(tmp / "gt"), _files(tmp / "gt_jax")
    assert len(got) == 6 and got == want
    # The annotation parser reads the same boxes the GT files hold.
    name, boxes = parse_annotation_line(anno.read_text().splitlines()[0])
    assert name == "imgs/img0.jpg"
    assert got["img0.txt"].decode().splitlines() == [
        f"{CLASSES[int(b[4])]} {b[0]} {b[1]} {b[2]} {b[3]}" for b in boxes]


@pytest.mark.parametrize("plot", [False, True])
def test_eval_map_matches_jax(gt_pred, plot):
    tmp, _ = gt_pred
    runs = {}
    for name, mod in (("port", evalmap), ("jax", jevalmap)):
        d = tmp / name
        runs[name] = mod.eval_map(str(tmp / "gt"), str(tmp / "pred"),
                                  str(d / "json"), str(d / "out"), plot=plot,
                                  verbose=False)
    assert runs["port"] == runs["jax"]
    assert 0.2 < runs["port"]["mAP"] < 1.0
    assert set(runs["port"]) == {"mAP", *CLASSES}
    for sub in ("json", "out"):
        assert _files(tmp / "port" / sub) == _files(tmp / "jax" / sub)
    out = _files(tmp / "port" / "out")
    assert out["output.txt"].startswith(b"# AP and precision/recall")
    if plot:
        assert {"ground-truth-info.png", "detection-results-info.png",
                "mAP.png"} <= set(out)
        assert (sorted(os.listdir(tmp / "port" / "out" / "classes"))
                == sorted(f"{c}.png" for c in CLASSES))


@pytest.mark.parametrize("rec,prec", [
    ([1.0], [1.0]),
    ([0.2, 0.4, 0.4, 0.8], [1.0, 0.5, 0.6667, 0.5]),
    ([1 / 3, 2 / 3, 2 / 3, 1.0], [1.0, 1.0, 2 / 3, 0.75]),
    ([], []),
])
def test_voc_ap_and_iou_match_jax(rec, prec):
    assert evalmap.voc_ap(rec[:], prec[:]) == jevalmap.voc_ap(rec[:], prec[:])
    for a, b in [([0, 0, 10, 10], [0, 0, 10, 10]),
                 ([0, 0, 10, 10], [10, 0, 20, 10]),
                 ([0, 0, 10, 10], [12, 0, 20, 10]),
                 ([1.5, 2, 30.25, 40], [3, 1, 28, 44.5])]:
        assert evalmap._iou_plus1(a, b) == jevalmap._iou_plus1(a, b)


VOC_XML = """<annotation>
  {filename}
  <object>
    <name>{cls}</name>
    <bndbox><xmin>10</xmin><ymin>20.7</ymin><xmax>110</xmax><ymax>220</ymax></bndbox>
  </object>
  <object>
    <name>unknown_class</name>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>2</xmax><ymax>2</ymax></bndbox>
  </object>
  <object>
    <name>cat</name>
    <bndbox><xmin>5</xmin><ymin>6</ymin><xmax>7.9</xmax><ymax>8</ymax></bndbox>
  </object>
</annotation>
"""


def test_xml_to_txt_matches_jax(tmp_path, capsys):
    xml_dir = tmp_path / "xmls"
    xml_dir.mkdir()
    for i, cls in enumerate(["dog", "cat", "unknown_class"]):
        name = f"<filename>scene_{i}.jpg</filename>" if i != 1 else ""
        (xml_dir / f"f{i}.xml").write_text(VOC_XML.format(filename=name,
                                                          cls=cls))
    for ext in (".jpg", ".png"):
        got, want = tmp_path / f"got{ext}.txt", tmp_path / f"want{ext}.txt"
        n = xml_to_txt.convert(str(xml_dir), CLASSES, str(got), img_ext=ext)
        assert n == jax_convert(str(xml_dir), CLASSES, str(want), img_ext=ext)
        assert got.read_bytes() == want.read_bytes()
    assert n == 3
    assert "f1.png 10,20,110,220,0 5,6,7,8,0" in got.read_text()
    # The command line writes the same file.
    classes = tmp_path / "classes.txt"
    classes.write_text("\n".join(CLASSES) + "\n")
    cli = tmp_path / "cli.txt"
    xml_to_txt.main(["--xml-dir", str(xml_dir), "--classes", str(classes),
                     "--output", str(cli), "--img-ext", ".png"])
    assert cli.read_bytes() == got.read_bytes()
    assert "wrote 3 annotation lines" in capsys.readouterr().out


def test_threaded_map_order_and_errors():
    assert list(threaded_map(lambda x: x * 2, range(10))) == [
        x * 2 for x in range(10)]

    def fn(x):
        if x == 3:
            raise RuntimeError("boom")
        return x

    out = []
    with pytest.raises(RuntimeError, match="boom"):
        for v in threaded_map(fn, range(10)):
            out.append(v)
    assert out == [0, 1, 2]


def test_threaded_map_abandoned_consumer_releases_producer():
    produced = []

    def fn(x):
        produced.append(x)
        return x

    before = threading.active_count()
    gen = threaded_map(fn, range(1000), depth=2)
    assert next(gen) == 0
    gen.close()  # the generator's finally: stop + drain
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 50
