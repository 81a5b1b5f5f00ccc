"""The benchmark of the PyTorch/CUDA port of the SWIM simulator (``kaboodle_tpu_torch``)."""
