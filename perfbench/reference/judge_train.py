"""Judging the program's first training steps against the reference's.

Three numbers, each the widest over its parts:
- ``loss_gap``: |program loss - reference loss| / |reference loss| over the
  checked steps;
- ``grad_gap``: for each parameter leaf, the gap between the norms of the
  program's first gradient (as its optimizer received it) and the
  reference's, over the larger of the reference's norm of that leaf and
  the median leaf's;
- ``change_gap``: the same for the change of each leaf over the checked
  steps, leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's: Adam moves those by rounding alone."""

from __future__ import annotations

import torch


def _norms(ts):
    return torch.stack([t.double().norm() for t in ts])


def leaf_gaps(got, want, keep=None):
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's; leaves outside ``keep`` read 0."""
    g, w = _norms(got), _norms(want)
    scale = torch.clamp(w, min=float((w[keep] if keep is not None
                                      else w).median()))
    gaps = (g - w).abs() / scale
    return gaps if keep is None else torch.where(keep, gaps, 0.0)


def worst_leaf(got, want, keep=None):
    return float(leaf_gaps(got, want, keep).max())


def worst_leaves(got, want, keep=None, top=5):
    """The ``top`` leaves with the widest gaps: (leaf index, gap, program
    norm, reference norm, median reference norm)."""
    gaps = leaf_gaps(got, want, keep)
    g, w = _norms(got), _norms(want)
    med = float((w[keep] if keep is not None else w).median())
    order = torch.argsort(gaps, descending=True)[:top]
    return [(int(i), float(gaps[i]), float(g[i]), float(w[i]), med)
            for i in order]


def judge(prog_losses, prog_grad, prog_change, ref_losses, ref_grad,
          ref_change):
    """The numbers above, and steadier ones: the first step's loss gap
    (``loss1_gap``), the median leaf's gaps of the gradient and the
    change (``grad_median``, ``change_median``), and the gap of the whole
    first gradient's norm over the reference's (``grad_total``)."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)]
    gn = _norms(ref_grad)
    keep = gn >= 1e-3 * float(gn.median())
    change = leaf_gaps(prog_change, ref_change, keep)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": worst_leaf(prog_grad, ref_grad),
            "grad_median": float(leaf_gaps(prog_grad, ref_grad).median()),
            "grad_total": abs(float(_norms(prog_grad).norm() / gn.norm())
                              - 1.0),
            "change_gap": float(change.max()),
            "change_median": float(change[keep].median())}
