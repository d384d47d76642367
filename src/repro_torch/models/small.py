"""The paper's task models (Appendix B.1): MLP, CNN, LSTM.

Each model is an ``nn.Module`` that holds only its configuration and takes
the parameters as a dict in ``forward(params, x)``, so a flat server vector,
a client's working copy and a reference tree can all drive it. Names and
layouts are the JAX package's, so flat vectors line up element for element:

* dense layers are ``{"w": (in, out), "b": (out,)}`` with ``x @ w + b``;
* CNN weights stay HWIO on NHWC inputs and are permuted at call time, and
  the features are flattened in (H, W, C) order before the classifier;
* each LSTM layer keeps ``wx (in, 4h)``, ``wh (h, 4h)`` and one ``b (4h,)``,
  with the gates in the order i, f, g, o (``nn.LSTM`` has two biases and
  another layout, so it is not used).

Initial values are drawn from a ``torch.Generator`` on the CPU and moved to
the device, so a seed gives the same model on every device. They are not the
JAX package's values (``jax.random`` cannot be reproduced); parity runs pass
the reference's params through ``repro_torch.convert.params_from_numpy``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_tasks import PaperTaskConfig
from repro_torch.utils import pytree as pt

PyTree = Any
Params = Dict[str, Any]


def _normal(g: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32) * scale


def _dense_init(g: torch.Generator, fan_in: int, fan_out: int) -> Params:
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return {"w": _normal(g, (fan_in, fan_out), scale),
            "b": torch.zeros((fan_out,))}


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


class PaperModel(nn.Module):
    """A paper model: ``init_params`` draws a param dict, ``forward`` runs
    it on a batch and returns logits."""

    def __init__(self, task: PaperTaskConfig):
        super().__init__()
        self.task = task

    def _init(self, g: torch.Generator) -> Params:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator,
                    device: torch.device) -> Params:
        return pt.tree_map(lambda t: t.to(device), self._init(generator))


class MLP(PaperModel):
    """Synthetic-1-1: 60-64-32-10 with ReLU."""

    def _init(self, g):
        t = self.task
        dims = (t.input_shape[0],) + t.hidden + (t.num_classes,)
        return {f"fc{i}": _dense_init(g, dims[i], dims[i + 1])
                for i in range(len(dims) - 1)}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        n = len(params)
        for i in range(n):
            x = _dense(params[f"fc{i}"], x)
            if i < n - 1:
                x = torch.relu(x)
        return x


class CNN(PaperModel):
    """FEMNIST: two 3x3 SAME convs, a 2x2 max-pool after each, then fc."""

    def _init(self, g):
        c1, c2 = self.task.hidden
        h, w, cin = self.task.input_shape
        feat = (h // 4) * (w // 4) * c2
        return {
            "conv1": {"w": _normal(g, (3, 3, cin, c1), 0.1),
                      "b": torch.zeros((c1,))},
            "conv2": {"w": _normal(g, (3, 3, c1, c2), 0.1),
                      "b": torch.zeros((c2,))},
            "fc": _dense_init(g, feat, self.task.num_classes),
        }

    @staticmethod
    def _conv(p: Params, x: torch.Tensor) -> torch.Tensor:
        # HWIO -> OIHW; x is NCHW here
        return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(self._conv(params["conv1"], x)), 2)
        x = F.max_pool2d(torch.relu(self._conv(params["conv2"], x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C) order
        return _dense(params["fc"], x)


class LSTM(PaperModel):
    """Shakespeare: char embedding, two LSTM layers, fc on the last state."""

    def _init(self, g):
        embed_dim, hidden = self.task.hidden
        v = self.task.num_classes

        def layer(in_dim, h_dim):
            s = (1.0 / max(in_dim, 1)) ** 0.5
            return {"wx": _normal(g, (in_dim, 4 * h_dim), s),
                    "wh": _normal(g, (h_dim, 4 * h_dim), s),
                    "b": torch.zeros((4 * h_dim,))}

        return {"embed": _normal(g, (v, embed_dim), 0.1),
                "lstm1": layer(embed_dim, hidden),
                "lstm2": layer(hidden, hidden),
                "fc": _dense_init(g, hidden, v)}

    @staticmethod
    def _scan(p: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D) -> (B, S, H)."""
        b, s, _ = x.shape
        h_dim = p["wh"].shape[0]
        xw = x @ p["wx"]                       # every step's input term
        h = x.new_zeros((b, h_dim))
        c = x.new_zeros((b, h_dim))
        hs = []
        for t in range(s):
            gates = xw[:, t] + h @ p["wh"] + p["b"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens]
        x = self._scan(params["lstm1"], x)
        x = self._scan(params["lstm2"], x)
        return _dense(params["fc"], x[:, -1])   # next char from last state


MODELS = {"mlp": MLP, "cnn": CNN, "lstm": LSTM}


@functools.lru_cache(maxsize=None)
def task_model(task: PaperTaskConfig) -> PaperModel:
    return MODELS[task.model](task)


def init_task_model(task: PaperTaskConfig, generator: torch.Generator,
                    device: torch.device) -> Params:
    return task_model(task).init_params(generator, device)


def task_fwd(task: PaperTaskConfig, params: Params, x: torch.Tensor):
    return task_model(task)(params, x)


def task_loss(task: PaperTaskConfig, params: Params, batch,
              prox: Optional[Tuple[float, PyTree]] = None) -> torch.Tensor:
    """Mean CE classification loss; optional FedProx proximal term (Eq. 39)."""
    x, y = batch
    logits = task_fwd(task, params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    if prox is not None:
        mu, anchor = prox
        sq = sum(torch.sum(torch.square(a - b)) for a, b in zip(
            pt.tree_leaves(params), pt.tree_leaves(anchor)))
        loss = loss + 0.5 * mu * sq
    return loss


def task_accuracy(task: PaperTaskConfig, params: Params,
                  batch) -> torch.Tensor:
    x, y = batch
    logits = task_fwd(task, params, x)
    return torch.mean((torch.argmax(logits, dim=-1) == y).float())
