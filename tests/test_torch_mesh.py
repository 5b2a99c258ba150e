"""The port's mesh helpers (``yolov4tpu_torch.parallel.mesh``) and the
multi-host data recipe (``utils.io.read_annotation_lines``) against the JAX
package's, with no JAX program compiled:

  - ``init_distributed`` at world size 1 on gloo, idempotent, its process
    group destroyed after each test (the pytest worker runs other files);
  - the refusal to continue alone when the environment looks multi-host
    (the JAX test's SLURM_NTASKS=4), the warning without hints, and NCCL
    asked for on a host without CUDA;
  - ``make_mesh`` asked for more ranks than the group has;
  - a world-size-1 mesh ``Trainer`` step bit-equal to the plain one (one
    rank's all-reduce is a copy, and x * 2 / 2 is exact);
  - ``shard_batch`` rows equal to JAX ``shard_batch``'s per device on a
    2-device mesh, on axis 0 and on the accumulation stacks' axis 1;
  - ``read_annotation_lines`` with ``test_size`` and ``shard`` equal to
    the JAX function (sklearn's ``train_test_split``).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import IMG, SHALLOW, to_torch, torch_params, train_batch
from yolov4tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolov4tpu.parallel.mesh import shard_batch as jax_shard_batch
from yolov4tpu.utils.io import read_annotation_lines as jax_read_lines
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.parallel import mesh as tmesh
from yolov4tpu_torch.utils.io import read_annotation_lines

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW,
          learning_rate=1e-3)
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


def test_init_distributed_world_size_one_is_idempotent(no_cluster):
    info = tmesh.init_distributed(num_processes=1, backend="gloo")
    assert info == {"process_id": 0, "num_processes": 1, "local_devices": 1,
                    "global_devices": 1, "backend": "gloo"}
    assert tmesh.init_distributed() == info
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1,
                                                   torch.device("cpu"))
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tmesh.make_mesh(2, device="cpu")
    # The facade's num_devices=2 builds the same mesh and meets the same
    # refusal.
    tp, ts = torch_params(C)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ttrain.Trainer(YoloConfig(**KW, num_devices=2), C, tp, ts,
                       device="cpu")


def test_make_mesh_needs_a_process_group(no_cluster):
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh(1, device="cpu")


def test_refuses_to_continue_alone_when_multi_host_hinted(no_cluster):
    no_cluster.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="looks multi-host.*SLURM_NTASKS"):
        tmesh.init_distributed(backend="gloo")
    assert not dist.is_initialized()
    no_cluster.delenv("SLURM_NTASKS")
    with pytest.warns(UserWarning, match="single-process"):
        info = tmesh.init_distributed(backend="gloo")
    assert info["num_processes"] == 1
    no_cluster.setenv("SLURM_NTASKS", "1")
    assert tmesh._multi_host_hints() == []


def test_nccl_on_a_host_without_cuda_raises(no_cluster):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="nccl.*CUDA"):
        tmesh.init_distributed(num_processes=1, backend="nccl")
    assert not dist.is_initialized()


def test_world_size_one_mesh_step_equals_the_plain_step(no_cluster):
    tmesh.init_distributed(num_processes=1, backend="gloo")
    tp, ts = torch_params(C)
    batch, _ = train_batch(3, 2, C)
    plain = ttrain.Trainer(YoloConfig(**KW), C, tp, ts, device="cpu")
    meshed = ttrain.Trainer(YoloConfig(**KW), C, tp, ts,
                            mesh=tmesh.make_mesh(1, device="cpu"))
    calls = []
    real = dist.all_reduce
    no_cluster.setattr(dist, "all_reduce",
                       lambda *a, **k: calls.append(1) or real(*a, **k))
    m_plain = plain.train_step(batch)
    assert calls == []
    m_mesh = meshed.train_step(batch)
    assert calls == [1]
    assert float(m_mesh["loss"]) == float(m_plain["loss"])
    for a, b in zip(ttrain.leaves((meshed.params, meshed.state)),
                    ttrain.leaves((plain.params, plain.state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_shard_batch_rows_equal_jax(batch_axis):
    batch, _ = train_batch(5, 4, C)
    if batch_axis == 1:
        batch = ttrain.tree_map(lambda x: np.stack([x, x[::-1]]), batch)
    jax_out = jax_shard_batch(batch, jax_make_mesh(2), batch_axis=batch_axis)
    for rank in range(2):
        mesh = tmesh.Mesh(rank=rank, size=2, device=torch.device("cpu"))
        got = ttrain.leaves(tmesh.shard_batch(to_torch(batch), mesh,
                                              batch_axis))
        want = []
        # jax.tree.map rebuilt the dict with sorted keys; walk it in the
        # port's key order.
        for x in ttrain.leaves({k: jax_out[k] for k in batch}):
            shard = sorted(x.addressable_shards,
                           key=lambda s: s.device.id)[rank]
            want.append(np.asarray(shard.data))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_shard_batch_refuses_an_uneven_split():
    mesh = tmesh.Mesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.shard_batch({"image": np.zeros((3, 2))}, mesh)


@pytest.mark.parametrize("test_size,shard", [
    (None, None), (None, (1, 3)), (0.1, None), (0.25, (0, 2)),
    (0.33, (2, 3)), (5, (1, 2))])
def test_read_annotation_lines_equals_jax(tmp_path, test_size, shard):
    path = tmp_path / "anno.txt"
    path.write_text("".join(f"img{i}.jpg {i},2,{i + 9},30,{i % 3}\n"
                            for i in range(37)))
    got = read_annotation_lines(str(path), test_size, 5566, shard)
    assert got == jax_read_lines(str(path), test_size, 5566, shard)
    if test_size is not None:
        assert read_annotation_lines(str(path), test_size, 7, shard) != got
