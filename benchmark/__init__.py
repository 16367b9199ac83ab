"""The benchmark of the PyTorch/CUDA port (``benchmark/run.py``)."""
