"""The port's gradient core with ``pallas_wgrad=True`` — every 3x3
stride-1 conv through ``ops.wgrad_cuda.conv3x3_s1``, whose weight gradient
is the plain version on the CPU — against the JAX package's with the Pallas
kernel in interpret mode (as tests/test_wgrad_pallas.py runs it).
tests/test_torch_train_port.py holds it against the port's own default
backward.

Tolerances: those of tests/test_torch_train_step.py (a fixed tolerance
plus twice the JAX package's own movement under a 1e-6 relative
perturbation of the images; see there why).
"""

import jax
import numpy as np

from _torch_parity import (IMG, SHALLOW, conv_leaves, rel_rms, to_torch,
                           torch_params, train_batch, well_conditioned)
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW)


def test_pallas_wgrad_core_matches_jax_interpret():
    params, state = well_conditioned(C)
    batch, _ = train_batch(4, 2, C)
    core = jax.jit(jtrain._make_grad_and_metrics(
        C, JaxConfig(**KW, pallas_wgrad=True)))
    g_j, st_j, m_j = core(params, state, batch)
    rng = np.random.default_rng(1)
    moved_img = batch["image"] * (1 + 1e-6 * rng.normal(
        size=batch["image"].shape))
    g_p, _, m_p = core(params, state,
                       dict(batch, image=moved_img.astype(np.float32)))
    tp, ts = torch_params(C)
    g_t, st_t, m_t = ttrain._make_grad_and_metrics(
        C, YoloConfig(**KW, pallas_wgrad=True))(tp, ts, to_torch(batch))
    loss_j = float(m_j["loss"])
    moved = abs(float(m_p["loss"]) - loss_j) / loss_j
    assert abs(float(m_t["loss"]) - loss_j) / loss_j <= 1e-5 + 2 * moved
    for a, b in zip(st_t["bn"], st_j["bn"]):
        if b is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=0, atol=1e-4)
    for (i, k, t), (_, _, j), (_, _, p) in zip(
            conv_leaves(g_t), conv_leaves(g_j), conv_leaves(g_p)):
        err, noise = rel_rms(t, j), rel_rms(p, j)
        assert err <= 1e-4 + 2 * noise, (i, k, err, noise)

