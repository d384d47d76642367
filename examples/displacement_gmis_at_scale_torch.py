"""Beyond-paper feature demo on the PyTorch port: the O(clients)-memory
displacement GMIS.

The paper's server stores EVERY past global model (GMIS) to evaluate
Eq.(6)'s Euclidean distance. For a 72B-parameter model at fp32 that is
~288 GB per retained version — a 64-deep ring would need ~18 TB. The
displacement accumulator stores ONE pytree per outstanding client instead
and produces the same staleness.

This demo runs both modes side by side on a reduced phi3-medium-14b and
asserts the gamma trajectories match, then reports the memory ratio at
qwen2-vl-72b's size. The twin of ``examples/displacement_gmis_at_scale.py``
with ``repro_torch``; it runs on the CUDA card, ``--device cpu`` on the CPU.

Run:  PYTHONPATH=src python examples/displacement_gmis_at_scale_torch.py \\
          [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import FedConfig
from repro_torch.core.server import ClientUpdate, make_server
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt
from repro_torch.utils.device import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must be present)")
args = ap.parse_args()
device = resolve_device(args.device)

cfg = configs.reduced(configs.get_arch("phi3-medium-14b"))
cfg = dataclasses.replace(cfg, dtype="float32")
params = M.init_model(torch.Generator(device=device).manual_seed(0), cfg)
fed = FedConfig(lam=1.0, eps=1.0, gmis_depth=64)

ring = make_server("asyncfeded", params, fed)
disp = make_server("asyncfeded-displacement", params, fed)


def make_delta(template, step):
    gen = torch.Generator(device=device).manual_seed(step * 7 + 1)
    return pt.tree_map(
        lambda p: 0.01 * torch.randn(p.shape, generator=gen, device=device),
        template)


# interleaved async flow: 3 clients snapshot, THEN deliveries arrive —
# so every delivery lands on a server that moved (gamma > 0)
for srv in (ring, disp):
    replies = {cid: srv.on_connect(cid) for cid in range(3)}
    for step in range(12):
        cid = step % 3
        reply = replies[cid]
        delta = make_delta(reply.params, step)
        replies[cid] = srv.on_update(
            ClientUpdate(cid, reply.iteration, 5, delta))

g_ring = [float(r.gamma) for r in ring.history]
g_disp = [float(r.gamma) for r in disp.history]
np.testing.assert_allclose(g_ring, g_disp, rtol=1e-4)
print("gamma trajectories identical across GMIS modes:")
for a, b in list(zip(g_ring, g_disp))[-5:]:
    print(f"  ring={a:.5f}  displacement={b:.5f}")

full = configs.get_arch("qwen2-vl-72b")
bytes_per_copy = full.param_count() * 4
print("\nat qwen2-vl-72b scale:")
print(f"  ring GMIS (depth 64): {64 * bytes_per_copy / 1e12:7.1f} TB")
print(f"  displacement (10 clients): {10 * bytes_per_copy / 1e12:7.1f} TB "
      f"(and O(1) in staleness depth)")
