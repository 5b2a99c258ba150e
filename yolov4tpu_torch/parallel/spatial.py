"""Inference sharded on the image's rows over the ranks of a mesh
(``Yolov4.distribute(axis="spatial")``).

The JAX package shards the images' H over its device mesh and lets GSPMD
partition every conv and pool, with the halo exchanges it needs.  Here
each rank runs the topology on its own rows and makes the exchanges
itself:

- ``shard_plan`` splits the coarsest grid (stride 32) into contiguous
  spans over the ranks, as evenly as possible, and scales them to every
  level, so each span starts on an even row wherever a stride-2 conv
  reads it.  W is never sharded, so a tensor's level is read from its
  width.  When the coarse grid has fewer rows than there are ranks, the
  last ranks hold no rows: each runs the forward on a phantom strip of
  zero rows of its own (one coarse row), which it neither sends nor
  returns, and makes every collective the others make.
- ``SpatialOps`` wraps an ops backend of ``models.network`` or
  ``models.quantize``: before each op whose window crosses rows (a 3x3
  conv, a downsampling conv, an SPP max pool) it extends this rank's rows
  with the rows it needs from the others (``exchange``: one
  ``all_gather`` of every rank's first and last k rows), runs the
  unchanged op on the extended tensor, and crops the output rows that came
  from the halo.  At an edge of the image nothing is received, and the
  op's own padding supplies the fill: zero for a conv, -inf for a float
  max pool, -128 for the int8 one.
- ``gather_spans`` gives every rank the whole height of the raw grids in
  one ``all_gather``, so each rank runs the decode and the NMS on them.

Only ``all_gather`` is used; gloo runs it on CUDA tensors too.  The
exchanges are counted in ``HALO_EXCHANGES`` (``all_gather`` calls),
``HALO_ROWS`` and ``HALO_BYTES`` (the rows this rank received and used,
and their bytes), as ``ops.nms_cuda`` counts its launches.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.quantize import _QVal
from .mesh import Mesh, _pack_bytes, _unpack_bytes

# Stride of the coarsest grid: shards are whole rows of it.
COARSE = 32

HALO_EXCHANGES = 0
HALO_ROWS = 0
HALO_BYTES = 0

Span = Tuple[int, int]


def shard_plan(height: int, ranks: int) -> List[Span]:
    """Each rank's rows [start, stop) of an image of ``height`` rows: the
    coarse grid's G = height / 32 rows in contiguous spans, the first
    G mod ranks ranks taking one more; ranks past G hold none (an empty
    span at ``height``)."""
    if height % COARSE or height <= 0:
        raise ValueError(f"spatial sharding needs a height that is a "
                         f"positive multiple of {COARSE}, got {height}")
    if ranks < 1:
        raise ValueError(f"ranks must be at least 1, got {ranks}")
    base, extra = divmod(height // COARSE, ranks)
    spans, start = [], 0
    for r in range(ranks):
        stop = start + COARSE * (base + (r < extra))
        spans.append((start, stop))
        start = stop
    return spans


def level_spans(plan: Sequence[Span], stride: int) -> List[Span]:
    """``plan`` (image rows) at the grid of ``stride``."""
    return [(a // stride, b // stride) for a, b in plan]


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def halo_bands(x, span: Span, k: int):
    """This rank's part of an exchange: its first and last ``k`` rows (its
    whole span where that is shorter), each band padded with zeros to ``k``
    rows, as one (2, B, k, W, C) NHWC tensor.  ``x`` is NCHW over exactly
    the rows of ``span`` (a phantom strip for an empty span sends
    nothing)."""
    h = _nhwc(x)
    bands = h.new_zeros((2, h.shape[0], k, h.shape[2], h.shape[3]))
    n = min(span[1] - span[0], k)
    if n:
        bands[0, :, :n] = h[:, :n]
        bands[1, :, :n] = h[:, h.shape[1] - n:]
    return bands


def halo_rows(spans: Sequence[Span], rank: int, lo: int, hi: int):
    """Where rank ``rank`` finds the rows it lacks: a list of (holder,
    band, first, count) runs, in row order, for the rows above its span and
    then the rows below it; band 1 (a holder's last rows) serves rows
    above, band 0 (its first rows) rows below.  A row within k of this
    rank's edge lies within k of its holder's edge, so the bands of width
    k = max(lo, hi) hold every such row, also where the halo crosses more
    than one rank.  An empty span receives nothing."""
    a, b = spans[rank]
    if a == b:
        return [], []
    height = max(stop for _, stop in spans)
    k = max(lo, hi)
    above, below = [], []
    for q, (aq, bq) in enumerate(spans):
        if q == rank or aq == bq:
            continue
        first, last = max(aq, a - lo), min(bq, a)
        if first < last:
            above.append((q, 1, first - max(aq, bq - k), last - first))
        first, last = max(aq, b), min(bq, b + hi, height)
        if first < last:
            below.append((q, 0, first - aq, last - first))
    return above, below


def assemble(x, parts, spans: Sequence[Span], rank: int, lo: int, hi: int):
    """This rank's rows ``x`` (NCHW) extended by the rows it lacks, taken
    from ``parts`` (every rank's ``halo_bands``, in rank order): (the
    extended NCHW tensor in channels_last memory, rows added above, rows
    added below)."""
    above, below = halo_rows(spans, rank, lo, hi)
    if not above and not below:
        return x, 0, 0
    pieces = [parts[q][band, :, i:i + n] for q, band, i, n in above]
    pieces.append(_nhwc(x))
    pieces += [parts[q][band, :, i:i + n] for q, band, i, n in below]
    ext = torch.cat(pieces, dim=1).permute(0, 3, 1, 2)
    return (ext, sum(n for *_, n in above), sum(n for *_, n in below))


def exchange(x, spans: Sequence[Span], mesh: Mesh, lo: int, hi: int):
    """``assemble`` over every rank's bands, which one ``all_gather`` of
    their bytes brings (any dtype).  Every rank of the mesh calls it at the
    same point, with tensors of the same batch, width, channels and
    dtype."""
    global HALO_EXCHANGES, HALO_ROWS, HALO_BYTES
    bands = halo_bands(x, spans[mesh.rank], max(lo, hi))
    flat = bands.view(-1).view(torch.uint8)
    gathered = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(gathered, flat, group=mesh.group)
    parts = [g.view(bands.dtype).view(bands.shape) for g in gathered]
    ext, top, bottom = assemble(x, parts, spans, mesh.rank, lo, hi)
    HALO_EXCHANGES += 1
    HALO_ROWS += top + bottom
    HALO_BYTES += (top + bottom) * bands[0, :, :1].numel() * x.element_size()
    return ext, top, bottom


def _tensor(v):
    """A value's tensor: a ``_QVal``'s int8 tensor."""
    return v.q if isinstance(v, _QVal) else v


def _like(v, t):
    """``t`` as a value of ``v``'s kind: a ``_QVal`` keeps its scale."""
    return _QVal(t, v.scale) if isinstance(v, _QVal) else t


class SpatialOps:
    """The topology's op set over this rank's rows of an image of ``plan``
    (``shard_plan``), around the ops backend ``ops``: the ops whose window
    crosses rows get the rows they need first (``exchange``), and their
    outputs lose the rows that came from the halo; 1x1 convs, upsample,
    concat and add run on the rows as they are.  ``width`` is the image's
    width, from which each tensor's stride is read.  The values may be
    ``models.quantize._QVal``: their int8 tensors are exchanged, their
    scales kept.  The backend must run the stem as plain convs
    (``s2d_stem=False``)."""

    def __init__(self, ops, plan: Sequence[Span], mesh: Mesh, width: int):
        if getattr(ops, "s2d_stem", False):
            raise ValueError("spatial sharding runs the stem as plain "
                             "convs: build the ops with s2d_stem=False")
        self.ops, self.plan, self.mesh, self.width = ops, plan, mesh, width

    def _extended(self, x, lo: int, hi: int):
        """(x extended by the halo, rows added above, rows added below)."""
        if self.mesh.size == 1:
            return x, 0, 0
        t = _tensor(x)
        spans = level_spans(self.plan, self.width // t.shape[-1])
        ext, top, bottom = exchange(t, spans, self.mesh, lo, hi)
        return _like(x, ext), top, bottom

    @staticmethod
    def _crop(y, top: int, bottom: int):
        if not top and not bottom:
            return y
        t = _tensor(y)
        return _like(y, t[:, :, top:t.shape[2] - bottom])

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        kw = dict(downsampling=downsampling, activation=activation,
                  batch_norm=batch_norm)
        if kernel_size == 1 and not downsampling:
            return self.ops.conv(x, filters, kernel_size, **kw)
        if downsampling:
            # Top pad by one, then stride 2 VALID: two rows above keep the
            # windows' parity, and the first output row is the halo's.
            ext, top, _ = self._extended(x, 2, 0)
            return self._crop(self.ops.conv(ext, filters, kernel_size, **kw),
                              top // 2, 0)
        half = kernel_size // 2
        ext, top, bottom = self._extended(x, half, half)
        return self._crop(self.ops.conv(ext, filters, kernel_size, **kw),
                          top, bottom)

    def maxpool(self, x, pool: int):
        ext, top, bottom = self._extended(x, pool // 2, pool // 2)
        return self._crop(self.ops.maxpool(ext, pool), top, bottom)

    def upsample(self, x):
        return self.ops.upsample(x)

    def concat(self, xs):
        return self.ops.concat(xs)

    def add(self, a, b):
        return self.ops.add(a, b)


def local_rows(images, plan: Sequence[Span], rank: int):
    """This rank's rows of an NHWC batch, or, for a rank that holds none, a
    phantom strip of one coarse row of zeros."""
    a, b = plan[rank]
    if a == b:
        return images.new_zeros((images.shape[0], COARSE,
                                 *images.shape[2:]))
    return images[:, a:b]


@torch.no_grad()
def gather_spans(tensors, spans, mesh: Mesh, dim: int = 1) -> list:
    """Every rank's rows of each of ``tensors`` concatenated along ``dim``
    in rank order: ``spans[i]`` gives each rank's (start, stop) rows of
    tensor i (a rank's tensor may hold more, a phantom strip; only its
    span's count is sent).  Each part is padded to the longest span, all of
    them go in one ``all_gather`` of one byte buffer, and each is trimmed
    again.  A one-rank mesh returns its input and makes no call."""
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    padded = []
    for t, s in zip(tensors, spans):
        longest = max(b - a for a, b in s)
        a, b = s[mesh.rank]
        shape = list(t.shape)
        shape[dim] = longest
        p = t.new_zeros(shape)
        p.narrow(dim, 0, b - a).copy_(t.narrow(dim, 0, b - a))
        padded.append(p)
    flat = _pack_bytes(padded, mesh.device)
    gathered = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(gathered, flat, group=mesh.group)
    per_rank = [_unpack_bytes(g, padded) for g in gathered]
    return [torch.cat([per_rank[q][i].narrow(dim, 0, b - a)
                       for q, (a, b) in enumerate(s)], dim=dim)
            for i, s in enumerate(spans)]


def sharded_apply(apply, mesh: Mesh, height: int):
    """A raw-grid forward with ``apply``'s signature (``network.
    apply_folded`` or ``quantize.apply_quantized``, which take
    ``wrap_ops``) over this rank's rows of images of ``height`` rows
    (``local_rows``), returning every rank the whole NHWC grids."""
    plan = shard_plan(height, mesh.size)

    def forward(folded, images, num_classes, compute_dtype, csp_repeats,
                s2d_stem=False):
        if s2d_stem:
            raise ValueError("spatial sharding runs with s2d_stem=False")
        width = images.shape[2]
        raws = apply(folded, images, num_classes, compute_dtype,
                     csp_repeats=csp_repeats, s2d_stem=False,
                     wrap_ops=functools.partial(SpatialOps, plan=plan,
                                                mesh=mesh, width=width))
        spans = [level_spans(plan, width // r.shape[2]) for r in raws]
        return gather_spans(raws, spans, mesh)

    return forward
