"""Build and load the CUDA kernels in ``csrc/`` (see ``build.py``)."""
