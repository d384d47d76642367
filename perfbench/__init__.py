"""The benchmark of the PyTorch port (``repro_torch``).

One command runs one cell once::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells; each cell
pairs a configuration (``perfbench/configs/<name>.json``) with a traffic
mix (``perfbench/traffic/<name>.json``), whose ``runner`` names the module
of ``perfbench/runners`` that runs it. Per-layer metrics are readers in
``perfbench/metrics/<name>.py``; frozen operation and byte counts are in
``perfbench/work``; the plain reference that decides ``correct`` is in
``perfbench/reference`` and imports nothing of the port.
"""
