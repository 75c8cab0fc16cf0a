"""The benchmark of the PyTorch/CUDA port (``accel_tpu_torch``); see
``benchmark/run.py``."""
