"""Data-parallel training steps of the reference: the batch of each step is
the ranks' shards, one block each; each block runs the forward with its
own batch statistics (``yolov4.forward_train``: no statistics shared
across blocks), its loss and its gradients by autograd; the step's
gradient and loss are the blocks' weighted by their image counts; then
Adam (Kingma and Ba, as torch.optim.Adam: lr 1e-4, betas 0.9 and 0.999,
eps 1e-8), all in float32 with TF32 off."""

from __future__ import annotations

import torch

from . import yolov4
from .loss import yolo_loss
from .train import leaves


def run_steps(params, steps_blocks, num_classes: int, steps: int = 3,
              lr: float = 1e-4, quant=None, device="cuda", b1=0.9, b2=0.999,
              eps=1e-8, depth=yolov4.topology.DEPTH):
    """Adam steps from ``params`` (copied, float32); ``steps_blocks``: for
    each step the list of the ranks' blocks, each (images (B, S, S, 3),
    labels [3 grids], true boxes (B, M, 4)) as numpy; ``quant`` as
    ``yolov4.forward_train`` takes it (the control of ``correct``).
    Returns (losses, first-step gradients, the last parameters)."""
    live = {"convs": [{k: v.detach().to(device, torch.float32).clone()
                       .requires_grad_(True) for k, v in p.items()}
                      for p in params["convs"]]}
    ts = leaves(live)
    m = [torch.zeros_like(t) for t in ts]
    v = [torch.zeros_like(t) for t in ts]
    losses, first = [], None
    with yolov4.strict_fp32():
        for step, blocks in enumerate(steps_blocks[:steps], 1):
            total = [torch.zeros_like(t) for t in ts]
            loss_sum, count = 0.0, 0
            for img, labels, boxes in blocks:
                n = len(img)
                img = torch.as_tensor(img, device=device)
                labels = [torch.as_tensor(x, device=device) for x in labels]
                boxes = torch.as_tensor(boxes, device=device)
                raws = yolov4.forward_train(live, img, num_classes, quant,
                                            depth)
                loss = yolo_loss(raws, labels, boxes, num_classes)
                grads = torch.autograd.grad(loss, ts)
                del raws
                with torch.no_grad():
                    for acc, g in zip(total, grads):
                        acc.add_(g, alpha=float(n))
                loss_sum += float(loss.detach()) * n
                count += n
            grads = [acc / count for acc in total]
            losses.append(loss_sum / count)
            if first is None:
                first = [g.detach().cpu() for g in grads]
            with torch.no_grad():
                for t, g, mi, vi in zip(ts, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vi.sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                    t.addcdiv_(mi, denom, value=-lr / (1 - b1 ** step))
    return losses, first, [t.detach().cpu() for t in ts]
