"""The plain reference of the benchmark: YOLOv4 in float32 PyTorch and
NumPy, written from the published description, importing nothing of the
program under test.  It works out from the inputs the benchmark made
(weights, images, annotation lines) everything it compares: the folded
forward, decode and exact combined NMS of inference, and the ingest, label
encoding, loss, gradients and Adam of training."""
