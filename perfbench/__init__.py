"""The benchmark of the PyTorch and CUDA port (``repro_torch``): see
``perfbench/run.py`` and ``BENCHMARK.json``."""
