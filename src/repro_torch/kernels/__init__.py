"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each family package holds ``ref.py`` (the plain versions, mirroring the
reference's ``ref.py``) and ``ops.py`` (the wrappers).  A wrapper runs the
plain version for a tensor on the CPU and the CUDA kernel for a tensor on
the card; ``cuda.py`` builds and loads the kernels on first use.
"""
