"""``yolov4tpu_torch.parallel.spatial`` in one process, the ranks emulated:

  - the shard plan: spans of whole stride-32 rows, as even as the coarse
    grid allows, ranks without rows only where it has fewer rows than
    there are ranks, an even start at every level a stride-2 conv reads;
  - the halo assembly: each emulated rank's rows extended from every
    rank's bands equal the slice of the global tensor around its span,
    for the halos of the 3x3 convs (1, 1), the downsampling convs (2, 0)
    and the SPP pools (2, 2), (4, 4), (6, 6), where a band spans two
    neighbours and where ranks hold no rows, in float32, bfloat16 and
    int8, the extended tensor in channels_last memory;
  - ``exchange`` and ``gather_spans`` through one ``all_gather`` each (the
    collective faked with the bytes the other ranks would send);
  - the exchanges of a forward from a shape-only pass (meta tensors): 29
    at the tests' shallow depth, 47 at full depth, one for each 3x3 conv
    of the JAX package's inventory and each SPP pool, and at 416^2 on two
    ranks the 112 rows (801,216 values an image) that cross the one
    boundary;
  - the sharded forward of emulated ranks (threads meeting in a faked
    ``all_gather``) equal to the single-device forward, float and int8,
    also with ranks that hold no rows.
"""

import functools
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import IMG, SHALLOW, images, port_calibrated
from yolov4tpu.models import network as jnetwork
from yolov4tpu_torch.models import network, quantize
from yolov4tpu_torch.parallel import spatial
from yolov4tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("height", [64, 96, 416, 608])
def test_shard_plan(height, ranks):
    plan = spatial.shard_plan(height, ranks)
    assert len(plan) == ranks
    assert plan[0][0] == 0 and plan[-1][1] == height
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c
    coarse = [(b - a) // 32 for a, b in plan]
    assert all((b - a) % 32 == 0 for a, b in plan)
    assert max(coarse) - min(coarse) <= 1
    assert coarse == sorted(coarse, reverse=True)
    idle = sum(1 for n in coarse if n == 0)
    assert idle == max(0, ranks - height // 32)
    # Every level a stride-2 conv reads (strides 1-16) starts each span on
    # an even row.
    for stride in (1, 2, 4, 8, 16):
        assert all(a % 2 == 0 for a, _ in spatial.level_spans(plan, stride))


@pytest.mark.parametrize("height,ranks", [(100, 2), (0, 1), (64, 0)])
def test_shard_plan_rejects(height, ranks):
    with pytest.raises(ValueError):
        spatial.shard_plan(height, ranks)


def _global(h, dtype, seed=0, b=2, c=5, w=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g) * 50
    if dtype == torch.int8:
        x = x.clamp(-127, 127)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


# (rows of the level, spans of it): even, uneven, one row a rank (a band
# crossing two neighbours), ranks without rows.
LEVELS = {
    "even": [(0, 4), (4, 8)],
    "uneven": [(0, 6), (6, 9), (9, 12)],
    "one_row": [(0, 1), (1, 2), (2, 3)],
    "idle": [(0, 1), (1, 2), (2, 2), (2, 2)],
    "wide": [(0, 26), (26, 52)],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("lo,hi", [(1, 1), (2, 0), (2, 2), (4, 4), (6, 6)])
def test_halo_assembly_equals_the_global_slice(lo, hi, level, dtype):
    spans = LEVELS[level]
    height = spans[-1][1]
    x = _global(height, dtype)
    k = max(lo, hi)
    parts = [spatial.halo_bands(x[:, :, a:b], (a, b), k) if b > a else
             spatial.halo_bands(x[:, :, :1], (a, b), k) for a, b in spans]
    for r, (a, b) in enumerate(spans):
        if a == b:
            continue
        ext, top, bottom = spatial.assemble(x[:, :, a:b], parts, spans, r,
                                            lo, hi)
        first, last = max(0, a - lo), min(height, b + hi)
        assert (top, bottom) == (a - first, last - b)
        assert ext.dtype == dtype
        assert torch.equal(ext, x[:, :, first:last])
        if top or bottom:
            assert ext.is_contiguous(memory_format=torch.channels_last)


def test_a_rank_without_rows_receives_and_sends_nothing():
    spans = LEVELS["idle"]
    assert spatial.halo_rows(spans, 2, 6, 6) == ([], [])
    x = _global(2, torch.float32)
    bands = spatial.halo_bands(x[:, :, :1], spans[3], 6)
    assert bands.shape == (2, 2, 6, 3, 5) and not bands.any()
    # The last real rank finds nothing below it in the idle ranks.
    above, below = spatial.halo_rows(spans, 1, 6, 6)
    assert above == [(0, 1, 0, 1)] and below == []


def _fake_all_gather(monkeypatch, per_rank, calls):
    """dist.all_gather filled with the bytes each rank would send."""
    def all_gather(parts, flat, group=None):
        calls.append(len(parts))
        for p, theirs in zip(parts, per_rank):
            p.copy_(theirs.reshape(-1).view(torch.uint8))
    monkeypatch.setattr(dist, "all_gather", all_gather)


def test_exchange_counts_one_all_gather(monkeypatch):
    spans = LEVELS["one_row"]
    x = _global(3, torch.bfloat16)
    per_rank = [spatial.halo_bands(x[:, :, a:b], (a, b), 6)
                for a, b in spans]
    calls = []
    _fake_all_gather(monkeypatch, per_rank, calls)
    monkeypatch.setattr(spatial, "HALO_EXCHANGES", 0)
    monkeypatch.setattr(spatial, "HALO_ROWS", 0)
    monkeypatch.setattr(spatial, "HALO_BYTES", 0)
    mesh = Mesh(rank=1, size=3, device=CPU)
    ext, top, bottom = spatial.exchange(x[:, :, 1:2], spans, mesh, 6, 6)
    assert calls == [3] and (top, bottom) == (1, 1)
    assert torch.equal(ext, x)
    assert (spatial.HALO_EXCHANGES, spatial.HALO_ROWS) == (1, 2)
    assert spatial.HALO_BYTES == 2 * 2 * 3 * 5 * 2   # rows x B W C x bytes


def test_gather_spans_concatenates_the_ranks_rows(monkeypatch):
    """Two grids, three ranks of 2, 1 and 0 rows (the last a phantom strip
    of one row): one all_gather, each part padded to the longest span."""
    g = torch.Generator().manual_seed(1)
    whole = [torch.randn(2, 6, 4, 7, generator=g),
             torch.randint(0, 9, (2, 3, 2, 7), generator=g).to(torch.int8)]
    spans = [[(0, 4), (4, 6), (6, 6)], [(0, 2), (2, 3), (3, 3)]]
    local = [[t[:, a:b] if b > a else t[:, :1] for t, (a, b) in
              zip(whole, (s[r] for s in spans))] for r in range(3)]
    sent = []
    for r in range(3):
        padded = []
        for t, s in zip(local[r], spans):
            longest = max(b - a for a, b in s)
            a, b = s[r]
            p = t.new_zeros((t.shape[0], longest, *t.shape[2:]))
            p[:, :b - a] = t[:, :b - a]
            padded.append(p)
        from yolov4tpu_torch.parallel.mesh import _pack_bytes
        sent.append(_pack_bytes(padded, CPU))
    calls = []
    _fake_all_gather(monkeypatch, sent, calls)
    for r in range(3):
        got = spatial.gather_spans(local[r], spans,
                                   Mesh(rank=r, size=3, device=CPU))
        for t, w in zip(got, whole):
            assert t.dtype == w.dtype and torch.equal(t, w)
    assert calls == [3, 3, 3]
    monkeypatch.setattr(dist, "all_gather", None)
    one = Mesh(rank=0, size=1, device=CPU)
    assert spatial.gather_spans(whole, [[(0, 6)], [(0, 3)]], one) == whole


def _shape_only_exchanges(monkeypatch, csp_repeats, side, rank):
    """(exchanges, rows received, values received an image) of rank
    ``rank`` of two in one forward of meta tensors at ``side``^2."""
    monkeypatch.setattr(dist, "all_gather", lambda parts, flat, group=None:
                        None)
    for name in ("HALO_EXCHANGES", "HALO_ROWS", "HALO_BYTES"):
        monkeypatch.setattr(spatial, name, 0)
    folded = {"convs": [
        {"w": torch.empty(s.filters, s.in_ch, s.kernel_size, s.kernel_size,
                          device="meta"),
         "b": torch.empty(s.filters, device="meta")}
        for s in network.conv_specs(80, tuple(csp_repeats))]}
    plan = spatial.shard_plan(side, 2)
    images = torch.empty(1, side, side, 3, device="meta")
    network.apply_folded(
        folded, spatial.local_rows(images, plan, rank), 80,
        csp_repeats=csp_repeats, s2d_stem=False,
        wrap_ops=functools.partial(spatial.SpatialOps, plan=plan,
                                   mesh=Mesh(rank=rank, size=2,
                                             device=torch.device("meta")),
                                   width=side))
    return (spatial.HALO_EXCHANGES, spatial.HALO_ROWS,
            spatial.HALO_BYTES // 4)


@pytest.mark.parametrize("csp_repeats,want", [(SHALLOW, 29),
                                              ((1, 2, 8, 8, 4), 47)])
def test_exchanges_of_a_forward(monkeypatch, csp_repeats, want):
    three = sum(1 for s in jnetwork.conv_specs(80, tuple(csp_repeats))
                if s.kernel_size == 3)
    assert want == three + 3     # and the three SPP pools
    side = IMG if csp_repeats == SHALLOW else 416
    for rank in (0, 1):
        n, _, _ = _shape_only_exchanges(monkeypatch, csp_repeats, side, rank)
        assert n == want


def test_rows_across_one_boundary_at_416(monkeypatch):
    """Full depth, 416^2, two ranks: each 3x3 conv moves one row each way,
    each downsample two rows up, the pools 6, 4 and 2 each way: 112 rows,
    801,216 values an image, the neighbour-only minimum."""
    got = [_shape_only_exchanges(monkeypatch, (1, 2, 8, 8, 4), 416, r)
           for r in (0, 1)]
    assert [g[1] for g in got] == [37 + 12, 37 + 14 + 12]
    assert sum(g[1] for g in got) == 112
    assert sum(g[2] for g in got) == 801216


def _emulated(monkeypatch, ranks, fn):
    """``fn(mesh)`` on ``ranks`` threads, each a rank of a mesh whose
    ``all_gather`` the threads meet in."""
    barrier = threading.Barrier(ranks, timeout=60)
    sent, local = {}, threading.local()

    def all_gather(parts, flat, group=None):
        sent[local.rank] = flat.clone()
        barrier.wait()
        for q, p in enumerate(parts):
            p.copy_(sent[q])
        barrier.wait()

    monkeypatch.setattr(dist, "all_gather", all_gather)
    out, errors = [None] * ranks, []

    def run(r):
        local.rank = r
        try:
            out[r] = fn(Mesh(rank=r, size=ranks, device=CPU))
        except BaseException as e:   # reported below, in the test's thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("side,ranks", [(IMG, 2), (IMG, 3), (96, 2),
                                        (96, 3), (IMG, 8)])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_sharded_forward_equals_single(monkeypatch, side, ranks, kind):
    params, state, _ = port_calibrated(3)
    folded = network.fold_bn(params, state)
    imgs = torch.from_numpy(images(7, 2, side).astype(np.float32) / 255.0)
    apply = network.apply_folded
    if kind == "int8":
        scales = quantize.calibrate(folded, imgs.numpy(), 3, torch.float32,
                                    csp_repeats=SHALLOW)
        folded = quantize.quantize_folded(folded, scales, 3, SHALLOW)
        apply = functools.partial(quantize.apply_quantized, scales=scales)
    folded = network.prepare_folded(folded, CPU)
    with torch.inference_mode():
        want = apply(folded, imgs, 3, torch.float32, csp_repeats=SHALLOW,
                     s2d_stem=False)
    plan = spatial.shard_plan(side, ranks)

    def rank(mesh):
        fwd = spatial.sharded_apply(apply, mesh, side)
        with torch.inference_mode():
            return fwd(folded, spatial.local_rows(imgs, plan, mesh.rank), 3,
                       torch.float32, SHALLOW)

    for got in _emulated(monkeypatch, ranks, rank):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_sharded_forward_refuses_the_s2d_stem():
    mesh = Mesh(rank=0, size=2, device=CPU)
    fwd = spatial.sharded_apply(network.apply_folded, mesh, IMG)
    with pytest.raises(ValueError, match="s2d_stem"):
        fwd({}, torch.zeros(1, 32, IMG, 3), 3, torch.float32, SHALLOW,
            s2d_stem=True)
    with pytest.raises(ValueError, match="s2d_stem"):
        spatial.SpatialOps(network._FoldedApplyOps({"convs": []},
                                                   s2d_stem=True),
                           [(0, 32), (32, 64)], mesh, IMG)
