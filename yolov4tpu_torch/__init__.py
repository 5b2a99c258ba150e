"""yolov4tpu_torch — the YOLOv4 framework on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``yolov4tpu``, which stays beside it as the
reference.  This package imports nothing of JAX or of ``yolov4tpu``.
"""

from .config import DEFAULT_CONFIG, YoloConfig  # noqa: F401


def __getattr__(name):
    # Lazy, so `import yolov4tpu_torch` does not pull in cv2 and pandas.
    if name == "Yolov4":
        from .api import Yolov4
        return Yolov4
    raise AttributeError(name)
