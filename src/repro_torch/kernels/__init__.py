"""Hand-written CUDA kernels for Hopper, one subpackage per JAX package
kernel family. Each has ``csrc/*.cu`` (built by ``build.py`` at first use),
a module with the ctypes wrappers and their plain PyTorch versions, and
``ops.py`` with the entry points the rest of the port calls.

* fedagg -- the AsyncFedED server's norms and AXPY sweeps
"""
