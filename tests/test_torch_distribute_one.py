"""``Yolov4.distribute`` in the test process, with no second rank:

  - at world size 1 (a one-rank gloo group, destroyed after the test) the
    distributed facade equals the plain one bit for bit, float and int8,
    and makes no collective; on the spatial axis it equals the plain
    facade with the s2d stem off (the axis turns it off, as the JAX
    package's does), bit for bit, and makes no halo exchange;
  - an ``axis`` outside batch and spatial raises ``ValueError`` with the
    JAX package's message, either axis without a process group raises the
    same ``RuntimeError``, a mesh needs a process group of the size asked
    for, and ``distribute`` takes the JAX package's parameters;
  - ``parallel.mesh``'s byte packing carries tensors of every dtype, views
    and numpy arrays bit for bit: ``replicate`` writes rank 0's bytes into
    every leaf in place, and ``gather_rows`` concatenates the ranks' rows
    in rank order, each through one collective (the collective faked with
    the bytes a second rank would send).
"""

import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import IMG, SHALLOW, images, port_calibrated
from yolov4tpu import api as japi
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.parallel import mesh as tmesh
from yolov4tpu_torch.parallel import spatial
from yolov4tpu_torch.train import leaves

C = 3
CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK") + tuple(name for name, _ in
                                     tmesh._MULTI_HOST_HINTS)


@pytest.fixture
def no_cluster(monkeypatch):
    """No process group and no cluster variables; the group a test makes
    is destroyed after it."""
    assert not dist.is_initialized()
    for name in CLUSTER_ENV:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def facades(tiny_classes):
    """Two port facades on the same calibrated weights."""
    params, state, _ = port_calibrated(C)
    cfg = YoloConfig(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW)
    out = []
    for _ in range(2):
        m = tapi.Yolov4(None, tiny_classes, config=cfg, device="cpu")
        m.sync_params(params, state)
        out.append(m)
    return out


def _forbid(monkeypatch, *names):
    def refuse(*a, **k):
        raise AssertionError("a one-rank mesh made a collective call")
    for name in names:
        monkeypatch.setattr(dist, name, refuse)


def test_world_size_one_equals_the_plain_facade(no_cluster, facades):
    plain, meshed = facades
    tmesh.init_distributed(num_processes=1, backend="gloo")
    assert meshed.distribute(1) is meshed
    assert (meshed._mesh.rank, meshed._mesh.size) == (0, 1)
    _forbid(no_cluster, "broadcast", "all_gather", "barrier")
    imgs = images(5, 3).astype(np.float32) / 255.0
    try:
        for wire in (imgs, (imgs * 255).round().astype(np.uint8)):
            for a, b in zip(meshed.predict_batch(wire),
                            plain.predict_batch(wire)):
                assert torch.equal(a, b)
        calib = images(0, 2).astype(np.float32) / 255.0
        for m in (plain, meshed):
            m.quantize(calib_imgs=calib)
        for a, b in zip(meshed.predict_batch(imgs),
                        plain.predict_batch(imgs)):
            assert torch.equal(a, b)
    finally:
        for m in (plain, meshed):
            m.dequantize()
        meshed._mesh = None


def test_spatial_world_size_one_equals_the_plain_facade(no_cluster, facades,
                                                        tiny_classes):
    """distribute(1, axis="spatial") runs the forward with the s2d stem off
    and no exchange: bit-equal to a plain facade without the stem, float
    (float and uint8 input), int8 and the raw grids; config unchanged."""
    params, state, _ = port_calibrated(C)
    plain = tapi.Yolov4(None, tiny_classes, device="cpu",
                        config=facades[0].config.replace(s2d_stem=False))
    plain.sync_params(params, state)
    meshed = facades[1]
    tmesh.init_distributed(num_processes=1, backend="gloo")
    assert meshed.distribute(1, axis="spatial") is meshed
    assert meshed.config.s2d_stem and meshed._axis == "spatial"
    _forbid(no_cluster, "broadcast", "all_gather", "barrier")
    no_cluster.setattr(spatial, "HALO_EXCHANGES", 0)
    imgs = images(5, 3).astype(np.float32) / 255.0
    try:
        for wire in (imgs, (imgs * 255).round().astype(np.uint8)):
            for a, b in zip(meshed.predict_batch(wire),
                            plain.predict_batch(wire)):
                assert torch.equal(a, b)
        x = torch.from_numpy(imgs)
        for a, b in zip(meshed._raw(x), plain._raw(x)):
            assert torch.equal(a, b)
        calib = images(0, 2).astype(np.float32) / 255.0
        for m in (plain, meshed):
            m.quantize(calib_imgs=calib)
        for a, b in zip(meshed.predict_batch(imgs),
                        plain.predict_batch(imgs)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="64 rows"):
            meshed.predict_batch(images(5, 1, 96))
    finally:
        for m in (plain, meshed):
            m.dequantize()
        meshed._mesh, meshed._axis = None, "batch"
        meshed._refresh_inference()
    assert spatial.HALO_EXCHANGES == 0


def test_distribute_axis_and_mesh_errors(no_cluster, facades):
    model = facades[0]
    # The JAX method checks the axis before it reads anything of its
    # facade.
    with pytest.raises(ValueError) as want:
        japi.Yolov4.distribute(object(), axis="pipeline")
    with pytest.raises(ValueError) as got:
        model.distribute(axis="pipeline")
    assert str(got.value) == str(want.value)
    for axis in ("batch", "spatial"):
        with pytest.raises(RuntimeError, match="init_distributed"):
            model.distribute(axis=axis)
    tmesh.init_distributed(num_processes=1, backend="gloo")
    for axis in ("batch", "spatial"):
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            model.distribute(2, axis=axis)
    assert model._mesh is None and model._axis == "batch"
    want = list(inspect.signature(japi.Yolov4.distribute).parameters)
    assert list(inspect.signature(tapi.Yolov4.distribute).parameters) == want


def _tree(seed: int):
    """Leaves of every kind a folded inference tree holds."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(4, 3, 3, 3, generator=g)
    return {"convs": [
        {"wq": torch.randint(-127, 128, (4, 27), generator=g,
                             dtype=torch.int8),
         "sw": torch.rand(4, generator=g), "b": torch.randn(4, generator=g)},
        {"w": w.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last),
         "b": torch.randn(3, generator=g).to(torch.bfloat16)}],
        "count": torch.tensor(seed, dtype=torch.int32),
        "scales": {"conv_in": np.random.default_rng(seed).random(
            5).astype(np.float32)}}


def _bits(tree):
    return [np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                       and x.dtype == torch.bfloat16 else x).tobytes()
            for x in leaves(tree)]


def test_replicate_writes_rank0_bytes_in_place(monkeypatch):
    mesh = tmesh.Mesh(rank=1, size=2, device=torch.device("cpu"))
    rank0, mine = _tree(0), _tree(1)
    calls = []

    def broadcast(flat, src, group=None):
        calls.append(src)
        flat.copy_(tmesh._pack_bytes(
            [tmesh._as_tensor(x) for x in leaves(rank0)], flat.device))

    monkeypatch.setattr(dist, "broadcast", broadcast)
    scales = mine["scales"]["conv_in"]
    w = mine["convs"][1]["w"]
    assert tmesh.replicate(mine, mesh) is mine
    assert calls == [0]
    assert _bits(mine) == _bits(rank0)
    # In place: the same objects, the numpy array written through.
    assert mine["scales"]["conv_in"] is scales and mine["convs"][1]["w"] is w
    assert w.is_contiguous(memory_format=torch.channels_last)
    one = tmesh.Mesh(rank=0, size=1, device=torch.device("cpu"))
    _forbid(monkeypatch, "broadcast")
    assert _bits(tmesh.replicate(_tree(2), one)) == _bits(_tree(2))


def test_gather_rows_concatenates_in_rank_order(monkeypatch):
    g = torch.Generator().manual_seed(0)

    def outputs(b):
        return [torch.rand(b, 7, 4, generator=g), torch.rand(b, 7,
                                                             generator=g),
                torch.randint(0, 3, (b, 7), generator=g).float(),
                torch.randint(0, 8, (b,), generator=g, dtype=torch.int32)]

    per_rank = [outputs(2) for _ in range(3)]
    calls = []

    def all_gather(parts, flat, group=None):
        calls.append(len(parts))
        for p, outs in zip(parts, per_rank):
            p.copy_(tmesh._pack_bytes(outs, p.device))

    monkeypatch.setattr(dist, "all_gather", all_gather)
    mesh = tmesh.Mesh(rank=1, size=3, device=torch.device("cpu"))
    got = tmesh.gather_rows(per_rank[1], mesh)
    assert calls == [3]
    for i, t in enumerate(got):
        want = torch.cat([outs[i] for outs in per_rank])
        assert t.dtype == want.dtype and torch.equal(t, want)
    one = tmesh.Mesh(rank=0, size=1, device=torch.device("cpu"))
    _forbid(monkeypatch, "all_gather")
    assert tmesh.gather_rows(per_rank[0], one) == per_rank[0]
