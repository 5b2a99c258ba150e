"""yolov4tpu_torch — the YOLOv4 framework on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``yolov4tpu``, which stays beside it as the
reference.  This package imports nothing of JAX or of ``yolov4tpu``.
"""

from .config import DEFAULT_CONFIG, YoloConfig  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy, so `import yolov4tpu_torch` does not pull in cv2 and pandas.
    if name == "Yolov4":
        from .api import Yolov4
        return Yolov4
    if name == "serving":
        # importlib, not `from . import serving`: that resolves the name
        # through getattr on this package and would come back here.
        import importlib
        return importlib.import_module(".serving", __name__)
    raise AttributeError(name)
