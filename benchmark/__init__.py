"""The benchmark of the PyTorch and CUDA port (``xmaps_tpu_torch``): see ``run.py``."""
