"""The user journeys as command lines, each the counterpart of the JAX
package's ``examples/`` script of the same name::

    python -m yolov4tpu_torch.examples.inference --weights W --image I
    python -m yolov4tpu_torch.examples.eval --weights W --anno A ...
    python -m yolov4tpu_torch.examples.train --anno A --classes C ...
    python -m yolov4tpu_torch.examples.export_serving export|run ...

Each runs on the card (``--device cuda``, the default, raises on a host
without CUDA); ``--device cpu`` runs the same code on the CPU.  Each module
has ``main(argv=None)``, so the journeys can also be called in-process.
"""
