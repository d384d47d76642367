"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode tokens with the ring-buffer KV cache, for any assigned architecture
at the reduced size. The twin of ``examples/serve_batched.py`` with
``repro_torch``; it runs on the CUDA card (every attention layer's decode
step through the hand-written decode kernel), ``--device cpu`` on the CPU.
An audio model (musicgen-large) returns Q = 4 codebook tokens per step.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py \\
          [--arch recurrentgemma-2b] [--batch 4] [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="recurrentgemma-2b",
                help="any assigned arch id (see repro_torch.configs)")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=32)
ap.add_argument("--gen-len", type=int, default=16)
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must be present)")
args = ap.parse_args()

out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
            gen_len=args.gen_len, device=args.device)
print(f"generated token matrix: {tuple(out.shape)}")
