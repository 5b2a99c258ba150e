"""The port's network (yolov4tpu_torch.models.network) against the JAX
package's: conv inventory, seeded init, BN folding, mish, the space-to-depth
stem kernels and the BN-folded forward, on the same numpy inputs.

Tolerances: the f32 forward agrees to rtol/atol 1e-4 (two CPU conv
libraries sum in different orders; the measured gap is ~5e-7 on O(0.5)
grids).  The bf16 forward rounds at the same places on both sides but
through different conv kernels, so it is held to 4 bf16 ulps of the
grids' largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, images, jax_fold_bn, jax_raws,
                           torch_params, well_conditioned)
from yolov4tpu.models import network as jnetwork
from yolov4tpu_torch.models import network as tnetwork


def _oihw(w):
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("num_classes,csp_repeats", [
    (80, (1, 2, 8, 8, 4)), (3, SHALLOW)])
def test_conv_specs_match_jax(num_classes, csp_repeats):
    want = jnetwork.conv_specs(num_classes, csp_repeats)
    got = tnetwork.conv_specs(num_classes, csp_repeats)
    assert len(got) == len(want)
    if csp_repeats == (1, 2, 8, 8, 4):
        assert len(got) == 110
    for g, w in zip(got, want):
        for field in w.__slots__:
            assert getattr(g, field) == getattr(w, field), (w, field)


def test_params_from_jax_transposes_kernels():
    params, state = well_conditioned(3)
    tp, ts = torch_params(3)
    for g, w in zip(tp["convs"], params["convs"]):
        assert g["w"].dtype == torch.float32 and g["w"].is_contiguous()
        np.testing.assert_array_equal(g["w"].numpy(), _oihw(w["w"]))
    for g, w in zip(ts["bn"], state["bn"]):
        if w is not None:
            np.testing.assert_array_equal(g["var"].numpy(), w["var"])


def test_fold_bn_matches_jax():
    params, state = well_conditioned(3)
    want = jax_fold_bn(params, state)["convs"]
    got = tnetwork.fold_bn(*torch_params(3))["convs"]
    for g, w in zip(got, want):
        # Same f32 arithmetic; XLA may use rsqrt for 1/sqrt: a few ulps.
        np.testing.assert_allclose(g["w"].numpy(), _oihw(w["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g["b"].numpy(), np.asarray(w["b"]),
                                   rtol=1e-6, atol=1e-7)


def test_mish_matches_jax():
    x = np.concatenate([np.linspace(-30, 30, 2001),
                        [-100.0, 19.99, 20.0, 20.01, 1e4]]).astype(np.float32)
    want = np.asarray(jnetwork._mish(jnp.asarray(x)))
    got = tnetwork._mish(torch.from_numpy(x)).numpy()
    # The same single-exp arithmetic; exp may differ by an ulp.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[x > 20], x[x > 20])


def test_s2d_stem_kernels_match_jax():
    params, state = well_conditioned(3)
    folded = jax_fold_bn(params, state)["convs"]
    w1, b1, w2 = folded[0]["w"], folded[0]["b"], folded[1]["w"]
    want = jnetwork._s2d_stem_kernels(w1, b1, w2)
    got = tnetwork._s2d_stem_kernels(torch.from_numpy(_oihw(w1)),
                                     torch.tensor(np.asarray(b1)),
                                     torch.from_numpy(_oihw(w2)))
    np.testing.assert_array_equal(got[0].numpy(), _oihw(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), _oihw(want[2]))


@pytest.mark.parametrize("s2d_stem", [True, False])
def test_apply_folded_matches_jax(s2d_stem):
    num_classes = 3
    params, state = well_conditioned(num_classes)
    imgs = images(11, 2).astype(np.float32) / 255.0
    want = jax_raws(params, state, imgs, num_classes, s2d_stem)
    folded = tnetwork.fold_bn(*torch_params(num_classes))
    got = tnetwork.apply_folded(folded, torch.from_numpy(imgs), num_classes,
                                csp_repeats=SHALLOW, s2d_stem=s2d_stem)
    for g, w, side in zip(got, want, (IMG // 8, IMG // 16, IMG // 32)):
        assert g.shape == (2, side, side, 3 * (5 + num_classes))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s2d_stem", [True, False])
def test_apply_folded_bf16_matches_jax(s2d_stem):
    num_classes = 3
    params, state = well_conditioned(num_classes)
    imgs = images(12, 2).astype(np.float32) / 255.0
    want = jax_raws(params, state, imgs, num_classes, s2d_stem, jnp.bfloat16)
    folded = tnetwork.prepare_folded(
        tnetwork.fold_bn(*torch_params(num_classes)),
        torch.device("cpu"), torch.bfloat16)
    got = tnetwork.apply_folded(folded, torch.from_numpy(imgs), num_classes,
                                compute_dtype=torch.bfloat16,
                                csp_repeats=SHALLOW, s2d_stem=s2d_stem)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=4 * 2.0 ** -8 * np.abs(w).max())


def test_prepare_folded_equals_plain_folded():
    """The folded params as the facade places them (channels_last kernels,
    cached s2d stem) give the same grids as the plain folded dictionary."""
    params, state = well_conditioned(3)
    imgs = torch.from_numpy(images(13, 1).astype(np.float32) / 255.0)
    folded = tnetwork.fold_bn(*torch_params(3))
    placed = tnetwork.prepare_folded(folded, torch.device("cpu"))
    for s2d_stem in (True, False):
        want = tnetwork.apply_folded(folded, imgs, 3, csp_repeats=SHALLOW,
                                     s2d_stem=s2d_stem)
        got = tnetwork.apply_folded(placed, imgs, 3, csp_repeats=SHALLOW,
                                    s2d_stem=s2d_stem)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)
