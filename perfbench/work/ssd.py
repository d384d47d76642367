"""Operations and bytes of the port's ``ssd_scan`` kernel at one launch's
shape: a frozen copy of ``repro_torch.kernels.ssd.ssd.ssd_work``."""
from typing import Tuple


def ssd_work(bs: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
             with_h0: bool) -> Tuple[int, int]:
    """(bytes, flops) the scan must move and do at (B, S, H, P, G, N) with
    chunk ``min(chunk, S)``: x, dt, b, c, a (and h0) read once, y and the
    final state written; C B^T over the L (L + 1) / 2 causal pairs of each
    chunk once per group (2N flops each), the weighted W X over them per
    head (2P flops each), and the chunk's state and the state's term per
    head (2 L P N each)."""
    L = min(chunk, s)
    nc = s // L
    nbytes = 4 * (2 * bs * s * h * p + bs * s * h + 2 * bs * s * g * n + h
                  + bs * h * p * n * (2 if with_h0 else 1))
    flops = (bs * nc * g * L * (L + 1) * n
             + bs * h * nc * (4 * L * p * n + L * (L + 1) * p))
    return nbytes, flops
