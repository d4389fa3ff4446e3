"""The benchmark of the PyTorch and CUDA port (``mtp_tpu_torch``): MD cells
driven by data. See ``mdbench/README.md``; run a cell with ``python -m
mdbench.run``."""
