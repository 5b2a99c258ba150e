"""The benchmark of the PyTorch and CUDA port ``yolov4tpu_torch``."""
