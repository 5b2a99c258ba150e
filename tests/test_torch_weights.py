"""The port's darknet .weights reader/writer and synthetic-weight helpers
(yolov4tpu_torch.weights) against the JAX package's: byte-equal synthetic
files, array-equal loads, and equal density calibration and busy heads.
"""

import io

import numpy as np
import pytest
import torch

from _torch_parity import images, jax_raws, torch_params, well_conditioned
from yolov4tpu import weights as jweights
from yolov4tpu_torch import weights as tweights


def _oihw(w):
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _assert_params_equal(tparams, jparams, heads_only=False):
    """Port (OIHW tensors) and JAX (HWIO numpy) conv lists, exactly equal
    (only the bias-carrying head convs if ``heads_only``)."""
    assert len(tparams["convs"]) == len(jparams["convs"])
    for g, w in zip(tparams["convs"], jparams["convs"]):
        if heads_only and "b" not in w:
            continue
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["w"].numpy(), _oihw(w["w"]))
        for key in set(w) - {"w"}:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


@pytest.fixture(scope="module")
def darknet_bytes():
    """80-class full-depth synthetic .weights bytes from both packages."""
    return (tweights.random_darknet_bytes(80, seed=3),
            jweights.random_darknet_bytes(80, seed=3))


def test_random_darknet_bytes_byte_equal(darknet_bytes):
    got, want = darknet_bytes
    assert len(got) == len(want)
    assert got == want


def test_load_darknet_weights_array_equal(darknet_bytes, tmp_path):
    data = darknet_bytes[1]
    jp, js = jweights.load_darknet_weights(io.BytesIO(data), 80)
    tp, ts = tweights.load_darknet_weights(io.BytesIO(data), 80)
    _assert_params_equal(tp, jp)
    for g, w in zip(ts["bn"], js["bn"]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g["mean"].numpy(), w["mean"])
            np.testing.assert_array_equal(g["var"].numpy(), w["var"])
    # The three head convs carry a bias and no BN.
    assert [i for i, b in enumerate(ts["bn"]) if b is None] == [93, 101, 109]

    # Writing the loaded tensors back reproduces the file byte for byte.
    path = tmp_path / "roundtrip.weights"
    tweights.save_darknet_weights(tp, ts, path)
    assert path.read_bytes() == data


def test_load_darknet_weights_rejects_mismatch(darknet_bytes):
    data = darknet_bytes[1]
    with pytest.raises(ValueError, match="not fully consumed"):
        tweights.load_darknet_weights(io.BytesIO(data + b"\0" * 4), 80)
    with pytest.raises(ValueError, match="truncated"):
        tweights.load_darknet_weights(io.BytesIO(data[:-4]), 80)


@pytest.mark.parametrize("spread", [None, 1.0])
def test_calibrate_detection_density_matches_jax(spread):
    num_classes = 3
    params, state = well_conditioned(num_classes)
    imgs = images(0, 2).astype(np.float32) / 255.0
    raws = jax_raws(params, state, imgs, num_classes)
    jp, jdelta = jweights.calibrate_detection_density(
        params, raws, num_classes, target_per_image=30.0, spread=spread)
    tp, tdelta = tweights.calibrate_detection_density(
        torch_params(num_classes)[0],
        [torch.tensor(r) for r in raws], num_classes,
        target_per_image=30.0, spread=spread)
    assert tdelta == jdelta
    # Only the head convs change; the others are passed through.
    _assert_params_equal(tp, jp, heads_only=True)
    assert tp["convs"][0]["w"] is torch_params(num_classes)[0]["convs"][0]["w"]


@pytest.mark.parametrize("hot", [
    ((2, 0, 0), (2, 1, 1)),
    ((0, 2, 1, 1.5), (1, 0, 2, 2.5), (2, 1, 2, 3.0), (2, 1, 0, 2.0))])
def test_force_busy_heads_matches_jax(hot):
    num_classes = 3
    params, _ = well_conditioned(num_classes)
    want = jweights.force_busy_heads(params, num_classes, hot=hot)
    got = tweights.force_busy_heads(torch_params(num_classes)[0], num_classes,
                                    hot=hot)
    _assert_params_equal(got, want, heads_only=True)
