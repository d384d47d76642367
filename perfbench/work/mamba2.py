"""Operations of a Mamba-2 forward pass (``perfbench/reference/mamba2.py``):
its SSD layers and the tied head."""
from perfbench.work import flops


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    return (cfg["num_layers"] * flops.ssd_layer(cfg, rows, seq)
            + flops.head(cfg, rows * seq))
