"""The plain reference that decides ``correct``: float32 PyTorch with no
kernel, cache or batching of the port, and nothing imported from it.

* :mod:`.ops` — matrix products (exact float32, or with their operands
  rounded to TF32 for the control), norms and the loss;
* :mod:`.mamba2` and :mod:`.danube` — the two models: each its forward
  pass, its weight layout (``leaf_specs``) and a tiny configuration for the
  tests (``TINY``); a model's module is found by the ``reference`` key of
  its configuration file;
* :mod:`.route` — top-k routing that follows the program's expert
  choices and judges them (``route_gap``, ``route_errors``);
* :mod:`.client` — a client's local round of momentum SGD;
* :mod:`.rule` — the AsyncFedED rule, Eq. 5-8, with the ring GMIS;
* :mod:`.federation` — the federation followed through its first drains.
"""
