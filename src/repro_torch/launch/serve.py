"""Serving: batched prefill, then greedy decode, for an assigned
architecture.

The JAX package's ``launch/serve.py`` in PyTorch: prefill with
``forward(collect_cache=True, logits_slice=1)`` builds the caches, the
attention caches are laid into ring buffers of the sliding window, then
tokens decode one at a time (greedy). On CUDA every RG-LRU layer's prefill
runs the hand-written scan kernel, every SSD layer's prefill the SSD chunked
scan kernel, and every attention layer's decode step the ring-buffer decode
kernel. The recurrent (RG-LRU, SSD) states and conv windows pass from the
prefill to the decode caches as they are.

An SSD model (mamba2-1.3b) scans its prompt in chunks of
``cfg.ssm.chunk_size`` (256; 32 reduced): a prompt longer than the chunk must
be a multiple of it, as in the reference, and raises otherwise.

Usage (``--device cpu`` runs on the CPU; the default is CUDA):
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 2 \\
      --prompt-len 32 --gen-len 16
  python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt
from repro_torch.utils.device import Device, resolve_device


def _prefill_into_decode_cache(cfg, caches, prompt_len, window, cache_len):
    """Convert forward-collected caches into fixed decode buffers."""
    attn_len = min(window, cache_len) if window else cache_len

    def fit(buf):
        # buf: (..., S, KV, D), possibly with a leading group dim
        s = buf.shape[-3]
        out = buf.new_zeros(buf.shape[:-3] + (attn_len,) + buf.shape[-2:])
        take = min(s, attn_len)
        # ring layout: the last `take` tokens land at slots
        # (prompt_len - take + i) % attn_len
        idx = (prompt_len - take + torch.arange(take, device=buf.device)
               ) % attn_len
        out[..., idx, :, :] = buf[..., s - take:, :, :]
        return out

    def convert(path_cache, kind):
        if kind == "attn":
            k, v = path_cache
            return (fit(k), fit(v))
        return path_cache  # rglru / ssd states carry over directly

    pat, n_groups, tail = M._grouping(cfg)
    out = {}
    if n_groups:
        out["layers"] = {f"b{i}_{kind}": convert(
            caches["layers"][f"b{i}_{kind}"], kind)
            for i, kind in enumerate(pat)}
    for j, kind in enumerate(tail):
        name = f"tail{j}_{kind}"
        out[name] = convert(caches[name], kind)
    return out


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor          # (B, gen_len) int64
    logits: List[torch.Tensor]    # per step (B, V), when kept
    prefill_s: float              # host seconds, ending in a device wait
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompt: torch.Tensor, gen_len: int, *,
             feed: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> Generation:
    """Prefill ``prompt`` (B, S) and decode ``gen_len`` tokens greedily:
    the prefill's last logits give the first token, and each of the
    ``gen_len - 1`` decode steps the next. With ``feed`` (B, gen_len) the
    decode steps take ``feed``'s tokens instead of their own (teacher
    forcing); the returned tokens are still the argmaxes."""
    device = prompt.device
    batch, prompt_len = prompt.shape
    cache_len = prompt_len + gen_len
    window = cfg.sliding_window
    t0 = time.perf_counter()
    logits, _, caches = M.forward(params, prompt, cfg, window=window,
                                  collect_cache=True, remat=False,
                                  q_chunk=max(16, prompt_len // 2),
                                  kv_chunk=max(16, prompt_len // 2),
                                  logits_slice=1)
    cache = _prefill_into_decode_cache(cfg, caches, prompt_len, window,
                                       cache_len)
    del caches
    tok = torch.argmax(logits, dim=-1)                  # (B, 1)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    kept = [logits[:, -1]] if keep_logits else []
    generated = [tok]
    t0 = time.perf_counter()
    for step in range(gen_len - 1):
        tok_in = tok if feed is None else feed[:, step:step + 1]
        logits, cache = M.decode_step(params, cache, tok_in,
                                      prompt_len + step, cfg, window=window)
        tok = torch.argmax(logits, dim=-1)
        generated.append(tok)
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(device)
    t_decode = time.perf_counter() - t0
    return Generation(torch.cat(generated, dim=-1), kept, t_prefill,
                      t_decode)


def serve_config(arch: str, reduced: bool = True):
    """The configuration :func:`serve` runs, as the JAX package's serve
    sets it: the arch, reduced by default (MoE dense), in f32."""
    cfg = configs.get_arch(arch)
    if reduced:
        cfg = configs.reduced(cfg)
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, impl="dense"))
    return dataclasses.replace(cfg, dtype="float32")


def make_prompt(cfg, batch: int, prompt_len: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """The JAX package's serve prompt: numpy's default_rng(seed) token ids."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, prompt_len)),
                           dtype=torch.int64, device=device)


def serve(arch: str, batch: int = 2, prompt_len: int = 32, gen_len: int = 16,
          seed: int = 0, reduced: bool = True, verbose: bool = True, *,
          params=None, device: Device = None) -> torch.Tensor:
    """Generate ``gen_len`` tokens for a random prompt; returns the tokens
    (B, gen_len). ``params`` is a tree of tensors to start from (moved to
    ``device``), else the model is drawn from ``seed``. ``device`` defaults
    to CUDA and raises without it; pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    cfg = serve_config(arch, reduced)
    if params is None:
        params = M.init_model(torch.Generator(device=device).manual_seed(seed),
                              cfg)
    else:
        params = pt.tree_map(lambda t: t.to(device), params)
    prompt = make_prompt(cfg, batch, prompt_len, seed, device)
    gen = generate(params, cfg, prompt, gen_len)
    if verbose:
        print(f"[serve] {arch}: prefill {prompt_len} toks in "
              f"{gen.prefill_s:.2f}s; decoded {gen_len} toks in "
              f"{gen.decode_s:.2f}s "
              f"({(gen_len - 1) / max(gen.decode_s, 1e-9):.1f} tok/s)")
        print(f"[serve] sample output ids: {gen.tokens[0][:16].tolist()}")
    return gen.tokens


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    serve(args.arch, args.batch, args.prompt_len, args.gen_len, args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
