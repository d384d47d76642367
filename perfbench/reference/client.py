"""A client's local round (the paper's Algorithm 2): K steps of SGD with
momentum, m = beta m + g and p = p - lr m, from the model it downloaded;
the upload is the change p_K - p_0."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.reference.ops import cross_entropy
from perfbench.weights import tree_of

Leaves = Dict[tuple, torch.Tensor]


def local_round(forward: Callable, params: Leaves, momentum: Optional[Leaves],
                batches: List[Tuple[torch.Tensor, torch.Tensor]], lr: float,
                beta: float) -> Tuple[Leaves, Leaves]:
    """Returns (delta, momentum after the round)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = ({k: torch.zeros_like(v) for k, v in p.items()} if momentum is None
         else {k: v.clone() for k, v in momentum.items()})
    for tokens, labels in batches:
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = cross_entropy(forward(tree_of(leaves), tokens), labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, v), g in zip(leaves.items(), grads):
                m[k] = beta * m[k] + g
                p[k] = v.detach() - lr * m[k]
    delta = {k: p[k] - params[k] for k in p}
    return delta, m
