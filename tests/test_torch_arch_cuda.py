"""The serving slice's CUDA kernels on the card, held against their plain
PyTorch versions, and the port's models and serve loop on CUDA against the
same on the CPU. Every test here needs a CUDA card and skips without one;
the file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_arch_cuda.py

Tolerances. rglru_scan: atol 1e-5 + rtol 1e-5 against the plain loop (the
kernel steps in the same order, but fuses each step's multiply and add, and
the card's expf may differ from the CPU's in the last bit).
swa_decode_attention: atol 1e-5 with f32 inputs (a softmax merged from
pieces of 8 to 64 slots), and 8e-3 with bf16 (the output rounds to bf16
once: half an ulp of values below 2).
ssd_scan: 1e-4 of the largest |y| (and of the largest |state|) against the
plain version, whose products cuBLAS sums in another order over up to
L * N = 32,768 terms. Model logits on the card against the CPU: rtol/atol
1e-4, as the CPU tests hold the port to the reference.

Training (``SSDScan``, ``RGLRUScan``): the gradients of a random linear
functional of each scan's outputs against autograd through the plain
version, and vmapped over clients against one call per client, to 1e-4 of
the largest gradient (SSD) and 1e-5 (RG-LRU); a two-layer full-width
mamba2-1.3b cohort fan-out against the loop engine's client steps, losses
to rtol 1e-5 and deltas to 1e-3 of the update's largest element: the
vmapped step's products are batched cuBLAS calls that sum in other orders,
and a delta (lr 3e-3 times the momentum) is a difference of parameters
some thousand times its size, so a gradient that differs in its last bits
moves the delta by a few of the parameters' ulps, ~1e-4 of the delta.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.swa_attn import ops as swa_ops
from repro_torch.kernels.swa_attn import swa_attn
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.utils import pytree as pt

requires_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                   reason="needs a CUDA card")


def gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@requires_cuda
@pytest.mark.parametrize("shape", [(4, 2064, 2560), (1, 100, 96),
                                   (2, 64, 128), (2, 65, 128), (3, 1, 8)])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_matches_plain(shape, with_h0):
    """Many chunks, a short last chunk, exactly one chunk and one past it,
    one step."""
    b, s, w = shape
    g = gen(s)
    la = -torch.rand(b, s, w, device="cuda", generator=g) * 0.3
    xi = torch.randn(b, s, w, device="cuda", generator=g)
    h0 = (torch.randn(b, w, device="cuda", generator=g) if with_h0
          else None)
    rglru.rglru_scan.launches = 0
    out, last = rglru.rglru_scan(la, xi, h0)
    ref, rlast = rglru.rglru_scan_plain(la, xi, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last, rlast, rtol=1e-5, atol=1e-5)
    again, _ = rglru.rglru_scan(la, xi, h0)
    assert torch.equal(out, again)
    assert rglru.rglru_scan.launches == 2


@requires_cuda
def test_rglru_bf16():
    g = gen(1)
    la = -torch.rand(2, 300, 256, device="cuda", generator=g) * 0.3
    xi = torch.randn(2, 300, 256, device="cuda",
                     generator=g).bfloat16()
    out, last = rglru.rglru_scan(la, xi)
    ref, rlast = rglru.rglru_scan_plain(la, xi)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=8e-3,
                               atol=1e-5)
    torch.testing.assert_close(last, rlast, rtol=1e-5, atol=1e-5)


@requires_cuda
@pytest.mark.parametrize("shape", [(2, 20, 64), (3, 77, 96), (2, 300, 100),
                                   (1, 129, 10), (2, 64, 40)],
                         ids=["under_one_stage", "ragged_s", "w_not_tile",
                              "w_not_mult_4", "one_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_stream_edges(shape, dtype, with_h0):
    """The one-pass stream at its edges: S shorter than one 32-step stage,
    S not a multiple of 32 or 64, W not a multiple of the 32-channel tile,
    rows that are not a multiple of 16 bytes (W = 10 in f32, W = 100 and 10
    in bf16: 4-byte copies and plain loads), and one whole tile. Within
    1e-5 (a bf16 h within 8e-3 of its value: it rounds once), bitwise
    repeatable, and a second call right after the first on the same stream
    gives the same bits."""
    b, s, w = shape
    g = gen(s * w)
    la = -torch.rand(b, s, w, device="cuda", generator=g) * 0.3
    xi = torch.randn(b, s, w, device="cuda", generator=g).to(dtype)
    h0 = (torch.randn(b, w, device="cuda", generator=g) if with_h0
          else None)
    out, last = rglru.rglru_scan(la, xi, h0)
    again, last2 = rglru.rglru_scan(la, xi, h0)
    ref, rlast = rglru.rglru_scan_plain(la, xi, h0)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(last, rlast, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again) and torch.equal(last, last2)


@requires_cuda
@pytest.mark.parametrize("shape", [(4, 2048, 10, 1, 256, 0.0),
                                   (4, 48, 10, 1, 256, 0.0),
                                   (2, 256, 8, 2, 64, 30.0),
                                   (2, 100, 8, 8, 80, 0.0),
                                   (1, 1, 16, 1, 4, 0.0),
                                   (2, 5, 16, 1, 128, 0.0),
                                   (3, 300, 16, 1, 256, 0.0),
                                   (2, 130, 4, 1, 68, 5.0),
                                   (4, 48, 48, 1, 128, 0.0),
                                   (2, 300, 48, 1, 128, 0.0),
                                   (2, 100, 48, 2, 64, 30.0),
                                   (2, 77, 17, 1, 256, 0.0),
                                   (3, 40, 32, 4, 128, 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_matches_plain(shape, dtype):
    """The serve shapes (2048 and 48 slots), a GQA map with a softcap, D of
    4, 64, 68, 80, 128 and 256, H / KV from 1 to 48 (granite-34b's MQA:
    three groups of 16 heads over one piece; 24 and 17: a last group of 8
    and of 1; qwen3-moe-30b-a3b's 32 on 4), a cache shorter than one piece
    and one that no piece divides; valid lengths of S, 0, 1, exactly one
    piece, one past a piece and a ragged set. In bf16, D = 4 and 68 take
    the 8-byte copies (rows not a multiple of 16 bytes), the others the
    16-byte ones."""
    b, s, h, kv, d, cap = shape
    g = gen(s)
    q = torch.randn(b, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, s, kv, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, s, kv, d, device="cuda", generator=g).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    swa_attn.swa_decode_attention.launches = 0
    piece = swa_attn.piece_slots(s, b * kv,
                                 build.sm_count(torch.device("cuda:0")))
    full = lambda n: torch.full((b,), n, dtype=torch.int32, device="cuda")
    lens = [full(s), full(0), full(1), full(piece), full(piece + 1),
            torch.arange(1, b + 1, dtype=torch.int32, device="cuda")
            * max(1, s // (b + 1))]
    for vl in lens:
        out = swa_attn.swa_decode_attention(q, k, v, vl, cap)
        ref = swa_attn.swa_decode_plain(q, k, v, vl, cap)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(out, swa_attn.swa_decode_attention(q, k, v, vl,
                                                              cap))
    assert swa_attn.swa_decode_attention.launches == 2 * len(lens)


@requires_cuda
def test_swa_rejects_what_the_kernel_does_not_take():
    """Any number of query heads per kv head is taken (17 on 1); a head dim
    that is not a multiple of 4 is not."""
    q = torch.zeros(1, 17, 8, device="cuda")
    k = torch.zeros(1, 4, 1, 8, device="cuda")
    vl = torch.ones(1, dtype=torch.int32, device="cuda")
    torch.testing.assert_close(swa_attn.swa_decode_attention(q, k, k, vl),
                               swa_attn.swa_decode_plain(q, k, k, vl))
    with pytest.raises(ValueError, match="head dim"):
        swa_attn.swa_decode_attention(q[..., :6].contiguous(),
                                      k[..., :6].contiguous(),
                                      k[..., :6].contiguous(), vl)
    with pytest.raises(ValueError, match="on cpu"):
        swa_ops.decode_attention(q[:, None], k.cpu(), k, 1)


@pytest.mark.skipif("torch.cuda.device_count() < 2",
                    reason="needs two or more CUDA cards")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_on_every_card(dtype):
    """The partial kernels' shared-memory attribute is per device: a decode
    whose pieces take more than the default 48 KB (64-slot pieces of
    D = 256) launches on every card, not only on the one that loaded the
    library, and gives the first card's bits."""
    outs = []
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(5)
        q = torch.randn(1, 10, 256, device=dev, generator=g).to(dtype)
        k = torch.randn(1, 2048, 1, 256, device=dev, generator=g).to(dtype)
        v = torch.randn(1, 2048, 1, 256, device=dev, generator=g).to(dtype)
        vl = torch.full((1,), 2048, dtype=torch.int32, device=dev)
        assert swa_attn.piece_slots(2048, 1, build.sm_count(dev)) == 64
        with torch.cuda.device(dev):
            out = swa_attn.swa_decode_attention(q, k, v, vl)
        ref = swa_attn.swa_decode_plain(q, k, v, vl)
        tol = 1e-5 if dtype == torch.float32 else 8e-3
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        outs.append(out.cpu())
    assert all(torch.equal(o, outs[0]) for o in outs)


def ssd_inputs(bs, s, h, p, g, n, seed, h0=False, dt_scale=1.0):
    """Model-layout SSD inputs on the card: dt softplus'ed, a = -exp(0.3 z),
    b and c scaled by 0.3, as the CPU tests draw them."""
    gg = gen(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gg)
    return (rnd(bs, s, h, p),
            dt_scale * torch.nn.functional.softplus(rnd(bs, s, h)),
            -torch.exp(0.3 * rnd(h)), 0.3 * rnd(bs, s, g, n),
            0.3 * rnd(bs, s, g, n), rnd(bs, h, p, n) if h0 else None)


def assert_scaled_close(got, want, tol=1e-4):
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, err


@requires_cuda
@pytest.mark.parametrize("shape", [(2, 512, 8, 64, 1, 128, 256),
                                   (2, 40, 8, 64, 1, 128, 256),
                                   (1, 96, 6, 16, 3, 16, 32),
                                   (2, 512, 8, 64, 4, 128, 256),
                                   (3, 64, 4, 8, 2, 16, 64),
                                   (1, 1, 2, 64, 1, 128, 256)])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_matches_plain(shape, with_h0):
    """(B, S, H, P, G, N, chunk): the serve widths over two chunks, a ragged
    chunk (S = 40 < 256), the reduced widths, groups of two heads, a 64-step
    chunk, one step. Held against the plain version and the model twin."""
    bs, s, h, p, g, n, chunk = shape
    x, dt, a, b, c, h0 = ssd_inputs(bs, s, h, p, g, n, seed=s + h,
                                    h0=with_h0)
    ssd.ssd_scan.launches = 0
    y, st = ssd_ops.ssd_chunked(x, dt, a, b, c, chunk, initial_state=h0)
    assert ssd.ssd_scan.launches == 1
    ry, rst = ssd_ops.ssd_chunked_plain(x, dt, a, b, c, chunk, h0)
    torch.cuda.synchronize()
    assert_scaled_close(y, ry)
    assert_scaled_close(st, rst)
    my, mst = SSM.ssd_chunked(x, dt, a, b, c, min(chunk, s),
                              initial_state=h0)
    assert_scaled_close(y, my)
    assert_scaled_close(st, mst)
    y2, st2 = ssd_ops.ssd_chunked(x, dt, a, b, c, chunk, initial_state=h0)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@requires_cuda
@pytest.mark.parametrize("shape", [(2, 512, 8, 16, 1, 32, 256, False),
                                   (2, 512, 8, 16, 1, 32, 256, True),
                                   (2, 32, 8, 16, 1, 32, 256, False),
                                   (2, 40, 8, 16, 1, 32, 256, True),
                                   (2, 512, 8, 16, 4, 32, 256, True),
                                   (1, 256, 4, 16, 4, 32, 64, True),
                                   (1, 256, 4, 16, 2, 32, 64, False),
                                   (1, 256, 8, 16, 1, 32, 64, True),
                                   (2, 100, 4, 16, 2, 32, 128, True),
                                   (1, 128, 4, 6, 2, 10, 64, True)],
                         ids=["serve", "serve_h0", "cut_32", "ragged_40",
                              "g4", "hg1_c64", "hg2_c64", "hg8_c64",
                              "ragged_tile", "p_n_not_mult_4"])
def test_ssd_shared_scores(shape):
    """The score tiles that the heads of a group share, at a small width:
    chip_smoke.py's five SSD_SHAPES (the serve prefill from zero and from a
    state, a chunk cut to 32, a ragged chunk of 40, G = 4), H / G of 1, 2
    and 8 with chunks of 64, one chunk of 100 (a full and a ragged query
    tile), and P and N that are not multiples of 4 (4-byte copies). Held
    against the plain version and the model twin, bitwise repeatable."""
    bs, s, h, p, g, n, chunk, with_h0 = shape
    x, dt, a, b, c, h0 = ssd_inputs(bs, s, h, p, g, n, seed=s + 7 * h + g,
                                    h0=with_h0)
    y, st = ssd_ops.ssd_chunked(x, dt, a, b, c, chunk, initial_state=h0)
    ry, rst = ssd_ops.ssd_chunked_plain(x, dt, a, b, c, chunk, h0)
    my, mst = SSM.ssd_chunked(x, dt, a, b, c, min(chunk, s),
                              initial_state=h0)
    torch.cuda.synchronize()
    for got, want in ((y, ry), (st, rst), (y, my), (st, mst)):
        assert_scaled_close(got, want)
    y2, st2 = ssd_ops.ssd_chunked(x, dt, a, b, c, chunk, initial_state=h0)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@requires_cuda
def test_ssd_row_layout_matches_plain():
    """ssd_scan on the (BH, S, P) row layout, the TPU kernel's."""
    x, dt, a, b, c, _ = ssd_inputs(1, 256, 6, 16, 1, 32, seed=9)
    xr, dtr = x[0].transpose(0, 1).contiguous(), dt[0].t().contiguous()
    br = b[0, :, 0][None].expand(6, -1, -1).contiguous()
    cr = c[0, :, 0][None].expand(6, -1, -1).contiguous()
    y, st = ssd.ssd_scan(xr, dtr, a, br, cr, chunk=128)
    ry, rst = ssd.ssd_scan_plain(xr, dtr, a, br, cr, chunk=128)
    assert_scaled_close(y, ry)
    assert_scaled_close(st, rst)


@requires_cuda
def test_ssd_large_decay_is_finite():
    """dt * a near -50 per step: exp(cum[l] - cum[s]) overflows above the
    diagonal, where the kernel never evaluates it."""
    x, dt, a, b, c, h0 = ssd_inputs(2, 512, 4, 64, 1, 128, seed=3, h0=True)
    dt = torch.full_like(dt, 50.0)
    a = torch.full_like(a, -1.0)
    y, st = ssd_ops.ssd_chunked(x, dt, a, b, c, 256, initial_state=h0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    ry, rst = ssd_ops.ssd_chunked_plain(x, dt, a, b, c, 256, h0)
    assert_scaled_close(y, ry)
    assert_scaled_close(st, rst)


@requires_cuda
def test_ssd_rejects_what_the_kernel_does_not_take():
    x, dt, a, b, c, _ = ssd_inputs(1, 64, 2, 128, 1, 16, seed=1)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_ops.ssd_chunked(x, dt, a, b, c, 64)
    x, dt, a, b, c, _ = ssd_inputs(1, 96, 2, 16, 1, 16, seed=1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd_chunked(x, dt, a, b, c, 64)


def _reduced(arch, **kw):
    return dataclasses.replace(configs.reduced(configs.get_arch(arch)),
                               dtype="float32", **kw)


@requires_cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "h2o-danube-1.8b"])
def test_model_on_cuda_matches_cpu(arch):
    """Prefill and eight decode steps on the card and on the CPU from the
    same weights: every RG-LRU prefill launched the scan kernel and every
    attention decode step the decode kernel."""
    cfg = _reduced(arch, num_layers=5)
    params = M.init_model(torch.Generator().manual_seed(0), cfg)
    gparams = pt.tree_map(lambda t: t.cuda(), params)
    prompt = torch.randint(0, cfg.vocab_size, (2, 70),
                           generator=torch.Generator().manual_seed(1))
    rglru.rglru_scan.launches = swa_attn.swa_decode_attention.launches = 0
    got = serve.generate(gparams, cfg, prompt.cuda(), 9, keep_logits=True)
    kinds = cfg.layer_kinds
    assert rglru.rglru_scan.launches == kinds.count("rglru")
    assert swa_attn.swa_decode_attention.launches == 8 * kinds.count("attn")
    want = serve.generate(params, cfg, prompt, 9, feed=got.tokens.cpu(),
                          keep_logits=True)
    for a, b in zip(got.logits, want.logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@requires_cuda
@pytest.mark.parametrize("prompt_len", [96, 20])
def test_mamba2_on_cuda_matches_cpu(prompt_len):
    """mamba2-1.3b reduced, 4 layers: the prefill (three chunks, or a chunk
    cut to 20) launches the SSD kernel once per layer, and the card's
    logits follow the CPU's over eight decode steps."""
    cfg = _reduced("mamba2-1.3b", num_layers=4)
    params = M.init_model(torch.Generator().manual_seed(0), cfg)
    gparams = pt.tree_map(lambda t: t.cuda(), params)
    prompt = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                           generator=torch.Generator().manual_seed(1))
    ssd.ssd_scan.launches = 0
    got = serve.generate(gparams, cfg, prompt.cuda(), 9, keep_logits=True)
    assert ssd.ssd_scan.launches == 4
    want = serve.generate(params, cfg, prompt, 9, feed=got.tokens.cpu(),
                          keep_logits=True)
    for a, b in zip(got.logits, want.logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@requires_cuda
def test_serve_defaults_to_cuda():
    tokens = serve.serve("recurrentgemma-2b", verbose=False)
    assert tokens.is_cuda and tokens.shape == (2, 16)


def scaled_errs(got, want):
    return [float((a - b).abs().max() / b.abs().max()) for a, b in
            zip(got, want)]


@requires_cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_function_gradients(with_h0):
    """SSDScan's gradients (the kernel forward, the plain VJP backward) equal
    autograd through the plain version, alone and vmapped over three
    clients with their own ``a``; one launch either way."""
    bs, s, h, p, g, n, chunk = 2, 512, 8, 64, 1, 128, 256
    gg = gen(21)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gg)
    wy, ws = rnd(bs, s, h, p), rnd(bs, h, p, n)

    def loss(scan):
        def f(x, dt, a, b, c, *h0):
            y, st = scan(x, dt, a, b, c, chunk, h0[0] if h0 else None)
            return (y * wy).sum() + (st * ws).sum()
        return f

    def inputs(seed):
        args = ssd_inputs(bs, s, h, p, g, n, seed, h0=with_h0)
        return args if with_h0 else args[:5]
    args = inputs(1)
    nums = tuple(range(len(args)))
    f = loss(ssd_ops.ssd_chunked)
    ssd.ssd_scan.launches = 0
    got = torch.func.grad(f, nums)(*args)
    assert ssd.ssd_scan.launches == 1
    want = torch.func.grad(loss(ssd_ops.ssd_chunked_plain), nums)(*args)
    assert max(scaled_errs(got, want)) <= 1e-4
    vargs = [torch.stack(t) for t in zip(*(inputs(2 + i) for i in range(3)))]
    ssd.ssd_scan.launches = 0
    vgot = torch.func.vmap(torch.func.grad(f, nums))(*vargs)
    assert ssd.ssd_scan.launches == 1
    for i in range(3):
        one = torch.func.grad(f, nums)(*(t[i] for t in vargs))
        assert max(scaled_errs([t[i] for t in vgot], one)) <= 1e-4


@requires_cuda
def test_rglru_function_gradients():
    b, s, w = 2, 300, 96
    gg = gen(22)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gg)
    wh, wl = rnd(b, s, w), rnd(b, w)

    def loss(scan):
        def f(log_at, xi, h0):
            hs, last = scan(log_at.contiguous(), xi.contiguous(),
                            h0.contiguous())
            return (hs * wh).sum() + (last * wl).sum()
        return f

    def inputs():
        return (-0.8 * torch.rand(b, s, w, device="cuda", generator=gg),
                rnd(b, s, w), rnd(b, w))
    f = loss(rglru_ops.RGLRUScan.apply)
    args = inputs()
    rglru.rglru_scan.launches = 0
    got = torch.func.grad(f, (0, 1, 2))(*args)
    assert rglru.rglru_scan.launches == 1
    want = torch.func.grad(loss(rglru.rglru_scan_plain), (0, 1, 2))(*args)
    assert max(scaled_errs(got, want)) <= 1e-5
    vargs = [torch.stack(t) for t in zip(*(inputs() for _ in range(3)))]
    rglru.rglru_scan.launches = 0
    vgot = torch.func.vmap(torch.func.grad(f, (0, 1, 2)))(*vargs)
    assert rglru.rglru_scan.launches == 1
    for i in range(3):
        one = torch.func.grad(f, (0, 1, 2))(*(t[i] for t in vargs))
        assert max(scaled_errs([t[i] for t in vgot], one)) <= 1e-5


@requires_cuda
def test_direct_kernel_calls_refuse_grad():
    x, dt, a, b, c, _ = ssd_inputs(1, 64, 2, 64, 1, 128, seed=3)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd.launch(x.requires_grad_(True), dt, a.repeat(1), b, c, chunk=64)
    la = -torch.rand(1, 8, 32, device="cuda").requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        rglru.rglru_scan(la, torch.randn(1, 8, 32, device="cuda"))
    with torch.no_grad():
        rglru.rglru_scan(la, torch.randn(1, 8, 32, device="cuda"))


@requires_cuda
def test_mamba2_full_width_cohort_step_equals_loop():
    """mamba2-1.3b at full width, two layers, 512 tokens x batch 2: one
    cohort fan-out of three clients (K 2, vmapped: one SSD launch per layer
    and step) against the loop engine's client steps from the same state."""
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.core import cohort
    from repro_torch.core.client import Client
    from repro_torch.core.tasks import ArchTask

    cfg = dataclasses.replace(configs.get_arch("mamba2-1.3b"), num_layers=2,
                              dtype="float32")
    task = ArchTask(cfg=cfg, shape=dataclasses.replace(
        TRAIN_4K, seq_len=512, global_batch=2))
    fed = dataclasses.replace(task.fed, num_clients=3)
    params = task.init(torch.Generator().manual_seed(0), "cuda")
    make = lambda: [Client(i, task, i, fed, seed=0, device="cuda")
                    for i in range(3)]
    loop = [c.run_local(params, 2, 0) for c in make()]
    ssd.ssd_scan.launches = 0
    coh = cohort.run_cohort(task, make(), params, [2] * 3, [0] * 3)
    assert ssd.ssd_scan.launches == 2 * cfg.num_layers
    flat = lambda tree: torch.cat([t.reshape(-1)
                                   for t in pt.tree_leaves(tree)])
    for (u, l), (v, m) in zip(loop, coh):
        assert scaled_errs([flat(v.delta)], [flat(u.delta)])[0] <= 1e-3
        assert m == pytest.approx(l, rel=1e-5)
