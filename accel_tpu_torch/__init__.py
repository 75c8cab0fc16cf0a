"""PyTorch/CUDA port of ``accel_tpu`` for NVIDIA Hopper (H100).

Mirrors ``accel_tpu``'s layout (``ops/``, ``models/``, ``core/``) so each
module sits beside its JAX counterpart's name; ``kernels/`` holds the
hand-written CUDA sources that replace the Pallas TPU kernels and their
build. The package imports ``torch`` and never ``jax`` or ``accel_tpu``.

Tensors are NCHW inside the package; flow is ``(N, 2, h, w)`` in channel
order ``(dx, dy)``. ``core.pipeline.clip_predictions`` keeps the JAX call
shape at its boundary: a ``(B, F, H, W, 3)`` clip in, ``(B, F, H, W)``
uint8 class maps out.
"""
