"""One module per traffic ``runner``: ``run(cell, seed, seconds, traced,
device, t_process)`` runs a cell once and returns a
:class:`perfbench.bench.Outcome`."""
