"""Decode attention over a ring-buffer KV cache: one query token per
sequence against a cache of S slots, the slots at or past ``valid_len``
masked, an optional tanh softcap, grouped-query heads.

On a CUDA tensor :func:`swa_decode_attention` launches one of its two
hand-written kernels (``csrc/swa_attn.cu``, built by ``nvcc`` for ``sm_90a``
at first use) or raises: f32 inputs the pieces design, bf16 inputs the
tensor-core design. On a CPU tensor it runs :func:`swa_decode_plain`, and on
a meta tensor (the dry run's trace) the same plain version computes shapes
only. Nothing falls back from one to the other.
``swa_decode_attention.launches`` goes up by one per call that launches a
kernel, ``swa_decode_attention.launches_tc`` by one per such call in bf16.
:func:`piece_slots` (f32) and :func:`tc_plan` (bf16) are the kernels' launch
shapes, computed here so that the CPU tests reach them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).with_name("csrc") / "swa_attn.cu"
_DTYPES = (torch.float32, torch.bfloat16)
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def swa_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor,
                     softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, D); caches (B, S, KV, D) with H a multiple of KV; valid_len
    (B,) -> (B, H, D) in q's dtype. The JAX package's
    ``models/layers.py::decode_attention`` on kv heads repeated to H, in
    f32: scores scaled by D^-0.5, softcapped, slots at or past valid_len set
    to -1e30, a softmax over the S slots, then the weighted sum of V."""
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    k, v = k_cache.float(), v_cache.float()
    if h != kv:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    sc = torch.einsum("bhd,bkhd->bhk", q.float(), k) * d ** -0.5
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < valid_len.reshape(-1, 1).to(q.device)
    sc = torch.where(valid[:, None, :], sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/swa_attn.cu``; :func:`_ready`
    lets its partial and tensor-core kernels take their shared memory on
    each device at its first launch there."""
    lib = build.load(SOURCE)
    lib.swa_decode_f32.argtypes = [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                                   _INT, _INT, _F, _F, _VP, _VP, _VP]
    lib.swa_decode_tc.argtypes = [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                                  _INT, _INT, _INT, _F, _F, _VP, _VP, _VP]
    lib.swa_scratch_floats.argtypes = [_INT, _INT, _INT, _INT, _INT]
    lib.swa_tc_scratch_floats.argtypes = [_INT, _INT, _INT, _INT]
    for name in ("swa_scratch_floats", "swa_tc_scratch_floats"):
        getattr(lib, name).restype = ctypes.c_int64
    for name in ("swa_decode_f32", "swa_decode_tc", "swa_init",
                 "swa_head_group", "swa_max_d", "swa_min_split",
                 "swa_max_split", "swa_tc_grain"):
        getattr(lib, name).restype = _INT
    lib.swa_error_string.argtypes = [_INT]
    lib.swa_error_string.restype = ctypes.c_char_p
    if ((lib.swa_head_group(), lib.swa_max_d(), lib.swa_min_split(),
         lib.swa_max_split(), lib.swa_tc_grain())
            != (HEAD_GROUP, MAX_D, MIN_SPLIT, MAX_SPLIT, TC_GRAIN)):
        raise RuntimeError("swa_attn.cu and the limits of swa_attn.py "
                           "disagree")
    return lib


@functools.lru_cache(maxsize=None)
def _ready(device: torch.device, lib: ctypes.CDLL) -> None:
    """Let the partial and tensor-core kernels take their shared memory on
    ``device``: CUDA keeps the attribute per device, so it is set at the
    first launch on each one."""
    with torch.cuda.device(device):
        err = lib.swa_init()
    if err:
        raise RuntimeError(f"swa_init failed on {device}: "
                           f"{lib.swa_error_string(err).decode()}")


#: what the kernel takes: any number of query heads per kv head, scored
#: ``HEAD_GROUP`` at a time over a piece held in shared memory, and a head
#: dim of at most 256 that is a multiple of 4 (``kHeadGroup``, ``kMaxD`` in
#: the source)
HEAD_GROUP, MAX_D = 16, 256
#: cache slots per block: a power of two from ``kMinSplit`` to ``kMaxSplit``
MIN_SPLIT, MAX_SPLIT = 8, 64


def piece_slots(s: int, groups: int, sms: int) -> int:
    """Cache slots per block for a cache of ``s`` slots, ``groups`` = B * KV
    (b, kv head) pairs and a card of ``sms`` SMs: the smallest power of two
    from ``MIN_SPLIT`` to ``MAX_SPLIT`` that cuts each pair's cache into
    no more pieces than it takes to give every SM a block, so that one wave
    of blocks asks for the whole cache at once. 64 at S = 2048 with four
    pairs on 132 SMs (128 blocks), 8 at S = 48 (24 blocks)."""
    want = -(-sms // max(groups, 1))       # pieces per pair
    per = -(-s // want)                    # slots per piece
    split = MIN_SPLIT
    while split < per and split < MAX_SPLIT:
        split *= 2
    return split


#: the bf16 kernel's grain (``kTcGrain``): a split is a whole number of
#: ``TC_GRAIN`` slots
TC_GRAIN = 64


def tc_plan(b: int, kv: int, s: int, sms: int) -> tuple:
    """The bf16 kernel's launch shape, (splits, slots per split), for a
    cache of ``s`` slots, ``b * kv`` (b, kv head) pairs and a card of
    ``sms`` SMs: each pair's cache cut into sms // pairs splits (at least
    one), each a whole number of ``TC_GRAIN`` slots, so that the grid has
    no more blocks than SMs and a block loops over many tiles. One split
    where the pairs alone fill more than half the card (the block then
    writes the output itself; no scratch, no merge): decode_32k's 128 and
    1024 pairs on 132 SMs, where 2 splits measured 3-15% slower on an H100
    (``repro_torch.tools.swa_probe``); 16 at long_500k's 8 pairs."""
    grains = -(-s // TC_GRAIN)
    want = max(1, min(grains, sms // max(b * kv, 1)))
    per = -(-grains // want)               # grains per split
    return -(-grains // per), per * TC_GRAIN


def launch_plan(dtype: torch.dtype, b: int, kv: int, s: int,
                sms: int) -> tuple:
    """Which design a call of ``dtype`` launches, and its shape: ("tc",
    splits, slots per split) from :func:`tc_plan` for bf16, ("pieces",
    slots per piece) from :func:`piece_slots` for f32."""
    if dtype == torch.bfloat16:
        return ("tc", *tc_plan(b, kv, s, sms))
    return ("pieces", piece_slots(s, b * kv, sms))


def swa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid_len: torch.Tensor,
                         softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, D); k_cache, v_cache (B, S, KV, D) un-repeated; valid_len
    (B,) int32. Returns (B, H, D) in q's dtype (f32 or bf16).

    Replaces the JAX package's
    ``kernels/swa_attn/swa_attn.py::swa_decode_attention``
    (``_swa_decode_kernel``). Decode only, on either device: it raises
    when an input requires grad with grad mode on, or under a
    ``torch.func`` transform (``build.refuse_autograd``), rather than hand
    back an output with no gradient. Bound by device memory: it must read the
    valid slots of K and V once, 2 * valid * KV * D elements per sequence,
    for 4 flops per element and query head (at the RecurrentGemma-2B serve
    shape 16.8 MB, 5.0 us at 3.35 TB/s).

    bf16 takes the tensor-core design (``swa_tc``, for decode at large
    batch): one block per (b, kv head, split of :func:`tc_plan`), looping
    over tiles of 64 or 128 slots that a ring of shared-memory stages fills
    by ``cp.async`` ahead of use; the H / KV query heads of the kv head are
    the rows of ``mma.sync`` products (scores, then P.V with P split into
    two bf16 halves so that it keeps f32's accuracy), with an online
    softmax in registers; splits, where there are more than one, merged as
    below. Rows of a multiple of 16 bytes are copied 16 bytes at a time,
    others (D % 8 == 4) 8 at a time.

    f32 takes the pieces design. It cuts the cache into
    pieces of :func:`piece_slots` slots, one block per (piece, b, kv head),
    enough blocks to fill the card. A block whose piece lies wholly at or
    past ``valid_len`` exits before it copies anything; the others request
    every byte they use (the queries and the piece's valid K and V rows)
    into shared memory with ``cp.async`` before any arithmetic, then score
    their slots for the H / KV query heads that share them, ``HEAD_GROUP``
    heads at a time while the piece stays in shared memory (so K and V are
    read once per piece whatever H / KV is: granite-34b's 48 heads on one kv
    head take three groups), as register tiles of 4 slots x 4 heads, take
    the softmax with 16 lanes per head, and sum P.V with one thread per
    (columns, four heads). A second launch,
    started early as a programmatic dependent, merges the live pieces'
    softmax partials in a fixed order (no atomics, the same bits on every
    call). S need not be a multiple of anything: the last piece (or tile)
    is short.
    """
    build.refuse_autograd("an input of swa_decode_attention (decode only)",
                          q, k_cache, v_cache)
    if not isinstance(q, torch.Tensor) or q.dim() != 3:
        raise ValueError("q must be a (B, H, D) tensor")
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    build.check_tensor("q", q, _DTYPES, (b, h, d), dev)
    build.check_tensor("k_cache", k_cache, (q.dtype,), (b, s, kv, d), dev)
    build.check_tensor("v_cache", v_cache, (q.dtype,), (b, s, kv, d), dev)
    build.check_tensor("valid_len", valid_len, (torch.int32,), (b,), dev)
    if h % kv:
        raise ValueError(f"{h} query heads do not share {kv} kv heads evenly")
    if dev.type in ("cpu", "meta"):
        return swa_decode_plain(q, k_cache, v_cache, valid_len, softcap)
    if d > MAX_D or d % 4:
        raise ValueError(f"the kernel takes a head dim <= {MAX_D} that is a "
                         f"multiple of 4; got {d}")
    lib = load_library()
    _ready(dev, lib)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_len.data_ptr(), b, h, s, kv, d)
    plan = launch_plan(q.dtype, b, kv, s, build.sm_count(dev))
    tc = plan[0] == "tc"
    if tc:
        splits, chunk = plan[1:]
        scratch = torch.empty(lib.swa_tc_scratch_floats(b, h, d, splits),
                              dtype=torch.float32, device=dev)
        err = lib.swa_decode_tc(*args, chunk, splits, d ** -0.5,
                                float(softcap), scratch.data_ptr(),
                                out.data_ptr(), build.stream(dev))
    else:
        split = plan[1]
        scratch = torch.empty(lib.swa_scratch_floats(b, h, s, d, split),
                              dtype=torch.float32, device=dev)
        err = lib.swa_decode_f32(*args, split, d ** -0.5, float(softcap),
                                 scratch.data_ptr(), out.data_ptr(),
                                 build.stream(dev))
    if err:
        raise RuntimeError("swa_decode_attention launch failed: "
                           f"{lib.swa_error_string(err).decode()}")
    swa_decode_attention.launches += 1
    swa_decode_attention.launches_tc += tc
    return out


swa_decode_attention.launches = 0
swa_decode_attention.launches_tc = 0
KERNELS = (swa_decode_attention,)
