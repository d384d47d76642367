"""Hand-written CUDA kernels for Hopper, one subpackage per JAX package
kernel family. Each has ``csrc/*.cu`` (built by ``build.py`` at first use),
a module with the ctypes wrappers and their plain PyTorch versions, and
``ops.py`` with the entry points the rest of the port calls.

* fedagg -- the AsyncFedED server's norms and AXPY sweeps: one arrival,
  int8 wire form, and a burst of B arrivals (f32, bf16 or int8 deltas); ``fedagg/sharded.py``
  runs them per shard of a model-sharded flat vector
* rglru -- the RG-LRU linear recurrence of a recurrent layer's prefill
* swa_attn -- one-token decode attention over a ring-buffer KV cache
* ssd -- the Mamba-2 SSD chunked scan of an SSD layer's prefill
"""
