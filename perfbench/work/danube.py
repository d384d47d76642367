"""Operations of an H2O-Danube forward pass
(``perfbench/reference/danube.py``): attention over the window, the SwiGLU
MLP and the head."""
from perfbench.work import flops


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    tokens = rows * seq
    mlp = 3 * 2 * cfg["d_model"] * cfg["d_ff"]
    return (cfg["num_layers"] * ((flops.attn_proj(cfg) + mlp) * tokens
                                 + flops.attn_scores(cfg, rows, seq))
            + flops.head(cfg, tokens))
