"""Bytes of the port's fedagg sweeps, and the bytes the AsyncFedED rule
itself needs for a drain. The sweep counts are frozen copies of
``repro_torch.kernels.fedagg.fedagg.norms_work``, ``norms_batched_work`` and
``apply_batched_work`` for f32 deltas, with the AXPY's 12 bytes an
element beside them."""
from typing import Tuple


def norms_work(n: int) -> Tuple[int, int]:
    """(bytes, flops) of one norms sweep: x_t, x_stale and the delta read
    once; a subtraction and two multiply-adds an element."""
    return 12 * n, 5 * n


def axpy_work(n: int) -> Tuple[int, int]:
    """(bytes, flops) of one AXPY sweep: x_t and the delta read, the new
    vector written; a multiply-add an element."""
    return 12 * n, 2 * n


def norms_batched_work(b: int, n: int) -> Tuple[int, int]:
    """(bytes, flops) of the batched norms for a burst of B: x_t, the B
    stales and the B deltas read once; B drifts, B squared drifts, B^2
    cross terms and the B(B+1)/2 Gram terms of one triangle."""
    return 4 * (b + 1) * n + 4 * b * n, (3 * b * b + 4 * b) * n


def apply_batched_work(b: int, n: int) -> Tuple[int, int]:
    """(bytes, flops) of the batched apply for a burst of B: x_t and the B
    deltas read once, the new vector written; B multiplies and B adds an
    element."""
    return 8 * n + 4 * b * n, 2 * b * n


def drain_sweep_bytes(b: int, n: int) -> int:
    """Bytes the port's sweeps move for a drain of B: the single pair for
    one arrival, the batched pair for more."""
    if b == 1:
        return norms_work(n)[0] + axpy_work(n)[0]
    return norms_batched_work(b, n)[0] + apply_batched_work(b, n)[0]


def rule_bytes(b: int, distinct_stales: int, n: int) -> int:
    """Bytes the rule needs for a drain of B f32 updates over n elements:
    x_t read once, each distinct stale snapshot read once, each delta read
    once, the new model written once."""
    return 4 * n * (2 + distinct_stales + b)
