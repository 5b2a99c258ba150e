"""Training steps of the reference: the forward with batch statistics
(``yolov4.forward_train``), the loss, gradients by autograd and Adam
(Kingma and Ba, as torch.optim.Adam: lr 1e-4, betas 0.9 and 0.999, eps
1e-8), all in float32 with TF32 off; or, for the control of ``correct``,
with every conv's operands rounded to float8 (``lowp``)."""

from __future__ import annotations

import torch

from . import yolov4
from .loss import yolo_loss


def leaves(params):
    """The parameter tensors in darknet order, each conv's in key order."""
    return [t for p in params["convs"] for t in p.values()]


def run_steps(params, batches, num_classes: int, steps: int = 3,
              lr: float = 1e-4, quant=None, device="cuda", b1=0.9, b2=0.999,
              eps=1e-8, depth=yolov4.topology.DEPTH, affine=False):
    """Adam steps from ``params`` (copied, float32) over ``batches``, each
    (images (B, S, S, 3), labels [3 grids], true boxes (B, M, 4)) as
    numpy; ``quant`` and ``affine`` as ``yolov4.forward_train`` takes them.
    Returns (losses, first-step gradients, the last parameters)."""
    live = {"convs": [{k: v.detach().to(device, torch.float32).clone()
                       .requires_grad_(True) for k, v in p.items()}
                      for p in params["convs"]]}
    ts = leaves(live)
    m = [torch.zeros_like(t) for t in ts]
    v = [torch.zeros_like(t) for t in ts]
    losses, first = [], None
    with yolov4.strict_fp32():
        for step, (img, labels, boxes) in enumerate(batches[:steps], 1):
            img = torch.as_tensor(img, device=device)
            labels = [torch.as_tensor(x, device=device) for x in labels]
            boxes = torch.as_tensor(boxes, device=device)
            raws = yolov4.forward_train(live, img, num_classes, quant, depth,
                                        affine=affine)
            loss = yolo_loss(raws, labels, boxes, num_classes)
            grads = torch.autograd.grad(loss, ts)
            del raws
            losses.append(float(loss.detach()))
            if first is None:
                first = [g.detach().cpu() for g in grads]
            with torch.no_grad():
                for t, g, mi, vi in zip(ts, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vi.sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                    t.addcdiv_(mi, denom, value=-lr / (1 - b1 ** step))
    return losses, first, [t.detach().cpu() for t in ts]
