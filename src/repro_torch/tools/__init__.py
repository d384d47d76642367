"""Command-line tools of the port. Each runs as ``python -m
repro_torch.tools.<name>`` and does nothing when imported."""
