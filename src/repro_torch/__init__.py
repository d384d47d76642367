"""AsyncFedED in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (which stays the reference). It imports
``torch`` and numpy only, never ``jax`` nor anything of ``repro``: the
numpy-only modules it needs are copied here. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
