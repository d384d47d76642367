"""The port's serving loop (launch/serve.py) against the JAX package's, at
the reduced size, f32: the reference's ``repro.launch.serve.serve`` draws its
weights with ``init_model(PRNGKey(seed), cfg)`` after its own config
changes; the test draws the same weights and hands them to the port's
``serve(params=...)``. recurrentgemma-2b: a 16-token prompt with 4 new
tokens, and an 80-token prompt with 8, which wraps the reduced model's
64-slot attention ring. mamba2-1.3b: a 16-token prompt (under the reduced
chunk of 32) with 4 new tokens, and a 96-token prompt (three chunks, the
state carried across them) with 8.

The generated token matrices must be equal. Then both models are fed the
reference's tokens (teacher forcing) and every step's logits agree within
rtol/atol 1e-4 (f32; sums in other orders, tests/test_torch_arch_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as C
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.swa_attn import swa_attn
from repro_torch.launch import serve as tserve

ARCH, BATCH, SEED = "recurrentgemma-2b", 2, 0
SSD_ARCH = "mamba2-1.3b"
KERNELS = (rglru.rglru_scan, swa_attn.swa_decode_attention, ssd.ssd_scan)


def reference_weights(arch=ARCH):
    cfg = dataclasses.replace(C.reduced(C.get_arch(arch)), dtype="float32")
    return cfg, JM.init_model(jax.random.PRNGKey(SEED), cfg)


def reference_logits(jp, cfg, prompt, feed, gen_len):
    """The reference's serve steps, fed ``feed``: each step's logits."""
    prompt_len = prompt.shape[1]
    logits, _, caches = JM.forward(
        jp, jnp.asarray(prompt, jnp.int32), cfg, window=cfg.sliding_window,
        collect_cache=True, remat=False, q_chunk=max(16, prompt_len // 2),
        kv_chunk=max(16, prompt_len // 2), logits_slice=1)
    cache = jserve._prefill_into_decode_cache(
        cfg, caches, None, prompt_len, cfg.sliding_window,
        prompt_len + gen_len)
    out = [logits[:, -1]]
    for step in range(gen_len - 1):
        logits, cache = JM.decode_step(
            jp, cache, jnp.asarray(feed[:, step:step + 1], jnp.int32),
            jnp.int32(prompt_len + step), cfg, window=cfg.sliding_window)
        out.append(logits[:, -1])
    return out


def check_serve(arch, prompt_len, gen_len):
    """The port's tokens equal the reference's, and its teacher-forced
    logits agree step by step."""
    cfg, jp = reference_weights(arch)
    want = np.array(jserve.serve(arch, BATCH, prompt_len, gen_len, SEED,
                                 verbose=False))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for k in KERNELS:
        k.launches = 0
    got = tserve.serve(arch, BATCH, prompt_len, gen_len, SEED, verbose=False,
                       params=tp, device="cpu")
    assert got.shape == (BATCH, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(k.launches == 0 for k in KERNELS)   # plain versions on the CPU

    # teacher-forced on the reference's tokens, step by step
    tcfg = tserve.serve_config(arch)
    prompt = tserve.make_prompt(tcfg, BATCH, prompt_len, SEED, "cpu")
    gen = tserve.generate(tp, tcfg, prompt, gen_len,
                          feed=torch.from_numpy(want).long(),
                          keep_logits=True)
    jl = reference_logits(jp, cfg, prompt.numpy(), want, gen_len)
    assert len(gen.logits) == len(jl) == gen_len
    for t, j in zip(gen.logits, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("prompt_len,gen_len", [(16, 4), (80, 8)],
                         ids=["short", "wraps"])
def test_serve_matches_reference(prompt_len, gen_len):
    check_serve(ARCH, prompt_len, gen_len)


@pytest.mark.parametrize("prompt_len,gen_len", [(16, 4), (96, 8)],
                         ids=["under_chunk", "three_chunks"])
def test_serve_mamba2_matches_reference(prompt_len, gen_len):
    check_serve(SSD_ARCH, prompt_len, gen_len)


def test_mamba2_prompt_must_fill_its_chunks():
    """A prompt longer than the chunk (32 reduced) and not a multiple of
    it fails in the reference's scan; the port raises, and does not pad."""
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tserve.serve(SSD_ARCH, 1, 40, 2, SEED, verbose=False, device="cpu")


def test_ring_layout_of_the_prefill_cache():
    """A prompt longer than the ring puts its last ``window`` tokens at
    slots (prompt_len - window + i) % window, the reference's layout."""
    cfg, _ = reference_weights()
    tcfg = tserve.serve_config(ARCH)
    rng = np.random.default_rng(0)
    k = rng.normal(size=(1, 2, 70, 1, 4)).astype(np.float32)  # group dim 1
    caches = {"layers": {"b0_rglru": (np.zeros((1, 2, 3)),) * 2,
                         "b1_rglru": (np.zeros((1, 2, 3)),) * 2,
                         "b2_attn": (k, k + 1)}}
    jc = jserve._prefill_into_decode_cache(
        cfg, jax.tree.map(jnp.asarray, caches), None, 70, 64, 74)
    tc = tserve._prefill_into_decode_cache(
        tcfg, jax.tree.map(torch.from_numpy, caches), 70, 64, 74)
    for a, b in zip(jax.tree.leaves(jc["layers"]["b2_attn"]),
                    tc["layers"]["b2_attn"]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, verbose=False)
