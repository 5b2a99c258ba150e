"""The port's file formats against the JAX package's: ``.npz`` checkpoints
written by either package load in the other with the same arrays, keys,
shapes and dtypes; the ``torch.distributed.checkpoint`` directories
round-trip; and keras ``.h5`` weight files read as the JAX package reads
them.  Every comparison is exact: the formats move float32 bytes.
"""

import numpy as np
import pytest
import torch

from _torch_parity import small_tree, to_numpy
from yolov4tpu import checkpoint as jckpt
from yolov4tpu import weights as jweights
from yolov4tpu.models import network as jnetwork
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch import checkpoint as tckpt
from yolov4tpu_torch import weights as tweights
from yolov4tpu_torch.models.network import params_from_jax, params_to_jax
from yolov4tpu_torch.train import leaves

C = 3


def _assert_trees_equal(got, want):
    """Two nested dict/list trees (tensors or arrays) with the same
    structure and keys and exactly equal leaves of equal dtypes."""
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        g, w = to_numpy(got), to_numpy(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_params_to_jax_inverts_params_from_jax():
    params, state = small_tree()
    back = params_to_jax(*params_from_jax(params, state))
    _assert_trees_equal(back, (params, state))
    # Copies: writing the port's tensors leaves the arrays as they were.
    tp, ts = params_from_jax(params, state)
    arrays = params_to_jax(tp, ts)
    tp["convs"][0]["gamma"].add_(1.0)
    np.testing.assert_array_equal(arrays[0]["convs"][0]["gamma"],
                                  params["convs"][0]["gamma"])


def test_jax_npz_loads_in_the_port(tmp_path):
    params, state = small_tree()
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, params, state, step=11, extra={"epoch": 4})
    tp, ts, step, extra = tckpt.load_npz(path)
    assert step == 11 and extra == {"epoch": 4}
    _assert_trees_equal((tp, ts), params_from_jax(params, state))
    assert tp["convs"][0]["w"].is_contiguous()


def test_port_npz_loads_in_jax(tmp_path):
    """Same key set, shapes and dtypes as the JAX package's own file of the
    same trees, with step, extra and the ``__none__`` entries."""
    params, state = small_tree(1)
    port, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tckpt.save_npz(port, params, state, step=7, extra={"epoch": 2})
    jckpt.save_npz(jax_file, params, state, step=7, extra={"epoch": 2})
    with np.load(port) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.endswith("__none__") for k in a.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    jp, js, step, extra = jckpt.load_npz(port)
    assert step == 7 and extra == {"epoch": 2}
    _assert_trees_equal((jp, js), (params, state))


def test_port_npz_round_trip(tmp_path):
    tp, ts = params_from_jax(*small_tree(2))
    path = str(tmp_path / "nested" / "dir" / "ck.npz")   # dirs auto-created
    tckpt.save_npz(path, *params_to_jax(tp, ts))
    got_p, got_s, step, extra = tckpt.load_npz(path)
    assert step == 0 and extra == {}
    _assert_trees_equal((got_p, got_s), (tp, ts))


def test_dcp_round_trip(tmp_path):
    tp, ts = params_from_jax(*small_tree(3))
    d = str(tmp_path / "dcp")
    tckpt.save_dcp(d, tp, ts, step=3)
    tckpt.save_dcp(d, tp, ts, step=12)
    tckpt.save_dcp(d, tp, ts, step=12)             # replaces step 12
    assert tckpt.latest_dcp_step(d) == 12
    got_p, got_s = tckpt.load_dcp(d, 12, device="cpu")
    _assert_trees_equal((got_p, got_s), (tp, ts))
    assert got_s["bn"][1] is None


def test_latest_dcp_step_empty_and_missing(tmp_path):
    assert tckpt.latest_dcp_step(str(tmp_path / "missing")) is None
    (tmp_path / "empty").mkdir()
    assert tckpt.latest_dcp_step(str(tmp_path / "empty")) is None


def test_load_dcp_defaults_to_the_card(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tckpt.load_dcp(str(tmp_path), 0)


# --- keras .h5 ----------------------------------------------------------------

def _write_keras_h5(path, num_classes, seed=0):
    """A keras ``save_weights`` ``.h5`` file (one group per layer at the
    root) of the full network with random float32 values."""
    import h5py
    specs = jnetwork.conv_specs(num_classes)
    rng = np.random.default_rng(seed)
    n = sum(s.kernel_size ** 2 * s.in_ch * s.filters + 4 * s.filters
            for s in specs)
    pool = rng.standard_normal(n, dtype=np.float32)
    used = 0

    def take(shape):
        nonlocal used
        size = int(np.prod(shape))
        used += size
        return pool[used - size:used].reshape(shape)

    def layer(root, name, weights):
        g = root.create_group(name)
        g.attrs["weight_names"] = [f"{name}/{k}:0".encode() for k in weights]
        for k, v in weights.items():
            g.create_dataset(f"{name}/{k}:0", data=v)

    with h5py.File(path, "w") as root:
        bn = 0
        for i, s in enumerate(specs):
            k, f_ = s.kernel_size, s.filters
            conv = {"kernel": take((k, k, s.in_ch, f_))}
            if not s.batch_norm:
                conv["bias"] = take((f_,))
            layer(root, f"conv2d_{i}" if i else "conv2d", conv)
            if s.batch_norm:
                layer(root, (f"batch_normalization_{bn}" if bn
                             else "batch_normalization"),
                      {"gamma": take((f_,)), "beta": take((f_,)),
                       "moving_mean": take((f_,)),
                       "moving_variance": np.abs(take((f_,)))})
                bn += 1


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    """The ``save_weights`` file, and a full-model save's layout whose
    ``model_weights`` group is an external link to that file's root (the
    same groups, without writing the 250 MB twice)."""
    import h5py
    d = tmp_path_factory.mktemp("h5")
    paths = {"save_weights": str(d / "save_weights.h5"),
             "model_weights": str(d / "model.h5")}
    _write_keras_h5(paths["save_weights"], C)
    with h5py.File(paths["model_weights"], "w") as f:
        f["model_weights"] = h5py.ExternalLink(paths["save_weights"], "/")
        f.attrs["keras_version"] = "2.x"
    return paths


@pytest.mark.parametrize("layout", ["save_weights", "model_weights"])
def test_load_keras_h5_matches_jax(h5_files, layout):
    want = params_from_jax(*jweights.load_keras_h5(h5_files[layout], C))
    got = tweights.load_keras_h5(h5_files[layout], C)
    _assert_trees_equal(got, want)
    assert len(got[0]["convs"]) == 110
    assert all(t.dtype == torch.float32 for t in leaves(got))


def test_load_keras_h5_wrong_class_count_raises(h5_files):
    path = h5_files["save_weights"]
    with pytest.raises(ValueError, match="does not match spec") as want:
        jweights.load_keras_h5(path, C + 1)
    with pytest.raises(ValueError, match="does not match spec") as got:
        tweights.load_keras_h5(path, C + 1)
    assert str(got.value) == str(want.value)


def test_facade_loads_keras_h5(h5_files, tiny_classes, tmp_path):
    """``Yolov4(weight_path=...)`` reads keras files by their extension
    (``.h5`` or ``.hdf5``)."""
    import os
    path = str(tmp_path / "weights.hdf5")
    os.symlink(h5_files["save_weights"], path)
    model = tapi.Yolov4(path, tiny_classes, device="cpu")
    _assert_trees_equal((model.params, model.state),
                        tweights.load_keras_h5(h5_files["save_weights"], C))
