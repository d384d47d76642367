"""The port's ring-buffer decode attention (kernels/swa_attn) against the
reference: its plain version, which the wrapper takes on the CPU, against
the reference's oracle ``swa_decode_ref`` and its Pallas kernel in
interpret mode (``decode_attention_pallas``), in the model's layout, for
grouped-query head maps up to MQA's 48 query heads on one kv head, f32 and
bf16, ``valid_len`` masks with poisoned
slots, a softcap, and a cache length that no 64-slot piece divides. Inputs
are drawn with numpy from a seed and handed to both.

Tolerances: f32 1e-5 (one softmax, summed in another order); bf16 2e-2, the
reference's own for its bf16 kernel (tests/test_kernels.py): the port
computes in f32 from the bf16 inputs and rounds once, the reference rounds
its products.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.swa_attn.ops import decode_attention_pallas
from repro.kernels.swa_attn.ref import swa_decode_ref
from repro.models.layers import _repeat_kv as jrepeat
from repro.models.layers import decode_attention as jdecode
from repro_torch.kernels.swa_attn import ops, swa_attn
from repro_torch.models import layers as L


@pytest.fixture(autouse=True)
def no_launches():
    swa_attn.swa_decode_attention.launches = 0
    swa_attn.swa_decode_attention.launches_tc = 0
    yield
    assert swa_attn.swa_decode_attention.launches == 0
    assert swa_attn.swa_decode_attention.launches_tc == 0


def inputs(b, s, h, kv, d, dtype="float32", seed=0):
    """q (B, 1, H, D) and caches (B, S, KV, D), as numpy arrays of
    ``dtype`` (the same values for both packages)."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    mk = lambda *shape: rng.normal(size=shape).astype(np_dt)
    return mk(b, 1, h, d), mk(b, s, kv, d), mk(b, s, kv, d)


def tt(a):
    """A numpy array (f32 or bf16) as a tensor of the same dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("gqa", [(8, 8), (8, 2), (4, 1), (24, 1), (48, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_against_oracle_and_pallas(gqa, dtype):
    """GQA maps up to the MQA of granite-34b (48 query heads on one kv
    head), which the card's kernel scores 16 heads at a time."""
    h, kv = gqa
    b, s, d = 2, 256, 64
    q, kc, vc = inputs(b, s, h, kv, d, dtype)
    vl = np.array([s // 2, s], np.int32)
    got = ops.decode_attention(tt(q), tt(kc), tt(vc), torch.from_numpy(vl))
    assert got.shape == (b, 1, h, d) and got.dtype == tt(q).dtype
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    jq, jk, jv = (jnp.asarray(a) for a in (q, kc, vc))
    close(got[:, 0], swa_decode_ref(jq[:, 0], jk, jv, jnp.asarray(vl)), tol)
    close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(vl),
                                       block_kv=64), tol)


def test_valid_len_masking_with_poisoned_slots():
    """Slots at or past valid_len do not change the result, however large:
    the reference's own test, plus a batch with two lengths."""
    b, s, h, kv, d = 2, 128, 4, 4, 32
    q, kc, vc = inputs(b, s, h, kv, d, seed=1)
    vl = torch.tensor([64, 100], dtype=torch.int32)
    out1 = ops.decode_attention(tt(q), tt(kc), tt(vc), vl)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[0, 64:], vc2[0, 64:] = 999.0, -999.0
    kc2[1, 100:], vc2[1, 100:] = -999.0, 999.0
    out2 = ops.decode_attention(tt(q), tt(kc2), tt(vc2), vl)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)
    want = decode_attention_pallas(*(jnp.asarray(a) for a in (q, kc2, vc2)),
                                   jnp.asarray(vl.numpy()), block_kv=32)
    close(out2, want, 1e-5)


@pytest.mark.parametrize("softcap", [0.5, 30.0])
def test_softcap(softcap):
    b, s, h, kv, d = 2, 256, 8, 2, 64
    q, kc, vc = inputs(b, s, h, kv, d, seed=2)
    q = q * 4.0                                       # scores past the cap
    vl = np.array([200, 256], np.int32)
    got = ops.decode_attention(tt(q), tt(kc), tt(vc), torch.from_numpy(vl),
                               softcap=softcap)
    jq, jk, jv = (jnp.asarray(a) for a in (q, kc, vc))
    close(got[:, 0], swa_decode_ref(jq[:, 0], jk, jv, jnp.asarray(vl),
                                    softcap=softcap), 1e-5)
    close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(vl),
                                       block_kv=64, softcap=softcap), 1e-5)
    plain = ops.decode_attention(tt(q), tt(kc), tt(vc), torch.from_numpy(vl))
    assert not torch.allclose(got, plain, atol=1e-3)


@pytest.mark.parametrize("valid", [48, 30, 0])
def test_ragged_cache_and_scalar_valid_len(valid):
    """The serve run's short cache (48 slots, MQA, D = 256) with one length
    for the whole batch, against the model-side oracle; valid_len 0 makes
    the softmax uniform over every slot, as in the reference."""
    b, s, h, kv, d = 4, 48, 10, 1, 256
    q, kc, vc = inputs(b, s, h, kv, d, seed=3)
    got = ops.decode_attention(tt(q), tt(kc), tt(vc), valid)
    jk, jv = (jrepeat(jnp.asarray(a), h) for a in (kc, vc))
    want = jdecode(jnp.asarray(q), jk, jv, valid)
    close(got, want, 1e-5)
    vec = ops.decode_attention(tt(q), tt(kc), tt(vc),
                               torch.full((b,), valid, dtype=torch.int32))
    assert torch.equal(got, vec)


def test_model_decode_attention_is_the_plain_version():
    """models.layers.decode_attention (repeated kv, as the reference's) and
    the kernel's plain version on un-repeated kv give the same bits."""
    b, s, h, kv, d = 2, 64, 8, 2, 32
    q, kc, vc = (tt(a) for a in inputs(b, s, h, kv, d, seed=4))
    vl = torch.tensor([40, 64], dtype=torch.int32)
    a = L.decode_attention(q, L._repeat_kv(kc, h), L._repeat_kv(vc, h), vl)
    b_ = ops.decode_attention(q, kc, vc, vl)
    assert torch.equal(a, b_)


@pytest.mark.parametrize("case", ["dtype_mix", "valid_i64", "heads",
                                  "q_rank", "cache_shape"])
def test_wrapper_rejects(case):
    b, s, h, kv, d = 2, 16, 4, 2, 8
    q, k, v = (tt(a) for a in inputs(b, s, h, kv, d))
    q = q[:, 0]
    vl = torch.full((b,), s, dtype=torch.int32)
    if case == "dtype_mix":
        k = k.bfloat16()
    elif case == "valid_i64":
        vl = vl.long()
    elif case == "heads":
        q = torch.zeros(b, 3, d)
    elif case == "q_rank":
        q = q[:, None]
    else:
        v = v[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        swa_attn.swa_decode_attention(q, k, v, vl)


@pytest.mark.parametrize("s,groups,sms,split", [
    (2048, 4, 132, 64),     # the serve shape: 32 pieces x 4 = 128 blocks
    (48, 4, 132, 8),        # the short serve run: 6 pieces x 4 = 24 blocks
    (256, 4, 132, 8),       # (2, 256, 8, 2, 64): 32 x 4 = 128 blocks
    (300, 3, 132, 8),
    (1, 1, 132, 8),         # never below MIN_SPLIT
    (1 << 16, 1, 132, 64),  # never above MAX_SPLIT
    (2048, 1, 132, 16),     # one pair: 128 pieces
    (2048, 4, 16, 64)])
def test_piece_slots(s, groups, sms, split):
    """The kernel's launch shape: a power of two from MIN_SPLIT to MAX_SPLIT
    slots per piece, the smallest that needs no more pieces than it takes
    to give every SM a block."""
    got = swa_attn.piece_slots(s, groups, sms)
    assert got == split
    assert swa_attn.MIN_SPLIT <= got <= swa_attn.MAX_SPLIT
    assert got & (got - 1) == 0
    want = -(-sms // groups)
    assert got == swa_attn.MAX_SPLIT or -(-s // got) <= want


@pytest.mark.parametrize("b,kv,s,sms,plan", [
    (128, 1, 2048, 132, (1, 2048)),    # decode_32k: recurrentgemma-2b
    (128, 8, 4096, 132, (1, 4096)),    # h2o-danube-1.8b
    (128, 1, 32768, 132, (1, 32768)),  # granite-34b
    (1, 8, 4096, 132, (16, 256)),      # long_500k: h2o-danube-1.8b
    (4, 1, 2048, 132, (32, 64)),       # the batch-4 serve shape
    (128, 1, 2048, 16, (1, 2048)),
    (128, 8, 4096, 16, (1, 4096)),
    (128, 1, 32768, 16, (1, 32768)),
    (1, 8, 4096, 16, (2, 2048)),
    (4, 1, 2048, 16, (4, 512))])
def test_tc_plan(b, kv, s, sms, plan):
    """The bf16 kernel's launch shape: (splits, slots per split), each
    split a whole number of TC_GRAIN slots covering the cache; one split
    where the (b, kv head) pairs fill more than half the card, and never
    more blocks than SMs."""
    got = swa_attn.tc_plan(b, kv, s, sms)
    assert got == plan
    splits, chunk = got
    assert chunk % swa_attn.TC_GRAIN == 0 and splits == -(-s // chunk)
    assert splits == 1 or (2 * b * kv <= sms and splits * b * kv <= sms)


@pytest.mark.parametrize("b,s,kv", [(128, 2048, 1), (4, 2048, 1),
                                    (1, 4096, 8), (2, 48, 4)])
def test_dtype_chooses_the_design(b, s, kv):
    """bf16 calls take the tensor-core design with tc_plan's shape, f32
    calls the pieces design with piece_slots' (the f32 path as it was)."""
    for sms in (132, 16):
        assert (swa_attn.launch_plan(torch.bfloat16, b, kv, s, sms)
                == ("tc", *swa_attn.tc_plan(b, kv, s, sms)))
        assert (swa_attn.launch_plan(torch.float32, b, kv, s, sms)
                == ("pieces", swa_attn.piece_slots(s, b * kv, sms)))
