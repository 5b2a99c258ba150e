"""``Trainer.fit`` — the epoch loop over a DataGenerator with the prefetch
thread — in the port and in the JAX package: two epochs of two steps from
the same parameters on the same JPEGs.

Tolerance: each epoch's mean loss within rel 3e-2.  The first step's loss
agrees to the float32 rounding sensitivity of the training forward at this
size (see tests/test_torch_train_step.py), but training at this size is
itself chaotic: the JAX package's own losses at steps 2 and 3 move by
0.45% and 1.0% when the first batch's images are perturbed by a relative
1e-6 (measured), and the port's differ from them by 0.3% and 0.4%.
"""

import numpy as np

from _torch_parity import SHALLOW, torch_params, well_conditioned
from test_torch_data import write_dataset
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.data.pipeline import DataGenerator as JaxGenerator
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data.pipeline import DataGenerator

IMG = 64
C = 3


def test_fit_history_matches_jax(tmp_path, tiny_classes):
    lines = write_dataset(tmp_path, n=4, seed=1)
    kw = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW)
    params, state = well_conditioned(C)
    jgen = JaxGenerator(lines, tiny_classes, str(tmp_path),
                        config=JaxConfig(**kw), seed=0, use_native=False)
    jt = jtrain.Trainer(JaxConfig(**kw), C, params, state)
    want = jt.fit(jgen, epochs=2, verbose=False)
    tgen = DataGenerator(lines, tiny_classes, str(tmp_path),
                         config=YoloConfig(**kw), seed=0, use_native=False)
    tt = ttrain.Trainer(YoloConfig(**kw), C, *torch_params(C), device="cpu")
    got = tt.fit(tgen, epochs=2, verbose=False)
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [0, 1]
    assert tt.global_step == jt.global_step == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=3e-2)
