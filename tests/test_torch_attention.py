"""The port's attention (K5's plain version, the oracles, the dispatch)
against the reference package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  K5's
plain version is held to the reference's Pallas kernel run in interpret
mode (``ops.attention(..., impl="interpret", block_q=64, block_k=64)``) at
the reference's own kernel-test tolerances (``tests/test_kernels.py``:
2e-5 in float32, 2e-2 in bf16), and to ``attention_ref`` at ragged
lengths the Pallas kernel cannot take; the port's oracles are held to the
reference's at 1e-5 (float32, the same sums).

The arithmetic of K5's bf16 tensor-core kernel (``csrc/
flash_attention_sm90.cuh``) is emulated here in plain torch and held to
the plain version at the card tests' shapes, within the card's bf16
tolerance; the wrapper's TMA precondition is tested on CPU tensors.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# tests/test_kernels.py's ATTN_CASES:
# B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, bf16
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, 0, False),
    (1, 128, 256, 8, 8, 32, True, 64, 128, False),
    (2, 64, 64, 4, 1, 64, False, None, 0, False),
    (1, 256, 256, 2, 2, 128, True, 128, 0, True),
    (2, 128, 128, 6, 3, 64, True, None, 0, False),
]
F32_TOL, BF16_TOL = 2e-5, 2e-2  # the reference's kernel-test tolerances
# tests/test_torch_gpu.py's ATTN_CASES, the shapes K5 is held to on the card:
# B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset
CARD_CASES = [(2, 128, 128, 4, 2, 64, True, None, 0),
              (1, 128, 256, 8, 8, 32, True, 64, 128),
              (2, 64, 64, 4, 1, 64, False, None, 0),
              (1, 256, 256, 2, 2, 128, True, 128, 0),
              (2, 128, 128, 6, 3, 64, True, None, 0),
              (2, 37, 37, 4, 2, 32, True, 16, 0),
              (1, 100, 100, 6, 2, 64, False, None, 0),
              (1, 300, 300, 10, 1, 256, True, 128, 0),
              (1, 100, 100, 4, 2, 64, True, None, -60),
              (1, 1000, 1000, 10, 1, 256, True, 2048, 0),
              (2, 777, 777, 8, 2, 128, True, 256, 0),
              (1, 100, 357, 4, 4, 256, True, None, 257),
              (1, 130, 201, 10, 1, 256, False, None, 0)]
CARD_TOL = 2e-5  # the card's: |o - o_plain| <= 2e-5 (1 + |o_plain|), + 1 ulp
REF_TOL = 1e-5  # float32 oracles against float32 oracles


def qkv(B, Sq, Skv, Hq, Hkv, D, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, Hq, D).astype(np.float32),
            r.randn(B, Skv, Hkv, D).astype(np.float32),
            r.randn(B, Skv, Hkv, D).astype(np.float32))


def both(arrays, bf16=False):
    jt = jnp.bfloat16 if bf16 else jnp.float32
    tt = torch.bfloat16 if bf16 else torch.float32
    return ([jnp.asarray(a, jt) for a in arrays],
            [torch.from_numpy(a).to(tt) for a in arrays])


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got)
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------- K5, plain version
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_plain_matches_reference_kernel_interpret(case, monkeypatch):
    B, Sq, Skv, Hq, Hkv, D, causal, win, qoff, bf16 = ATTN_CASES[case]
    j, t = both(qkv(B, Sq, Skv, Hq, Hkv, D, seed=case), bf16)
    o_r = rops.attention(*j, causal=causal, window=win, q_offset=qoff,
                         impl="interpret", block_q=64, block_k=64)
    o_p = tfa.flash_attention_plain(*t, causal=causal, window=win,
                                    q_offset=qoff)
    assert o_p.dtype == t[0].dtype and o_p.shape == t[0].shape
    close(o_p, o_r, BF16_TOL if bf16 else F32_TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted: held
    # by a spy, since two calls of the plain version on a multithreaded
    # CPU BLAS may split their reductions differently
    calls = []
    real = tfa.flash_attention_plain

    def plain(*args):
        calls.append((args, real(*args)))
        return calls[-1][1]

    monkeypatch.setattr(tfa, "flash_attention_plain", plain)
    n = tfa.flash_attention.launches
    o_w = tfa.flash_attention(*t, causal=causal, window=win, q_offset=qoff,
                              block_q=64, block_k=64)
    assert tfa.flash_attention.launches == n
    assert len(calls) == 1 and o_w is calls[0][1]
    assert all(a is b for a, b in zip(calls[0][0], t))
    assert calls[0][0][3:6] == (causal, win, qoff)


@pytest.mark.parametrize("S", [37, 100])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_plain_matches_reference_oracle_at_ragged_lengths(S, causal, window):
    """Lengths that are no multiple of a block: the Pallas kernel asserts
    there (``flash_attention.py:110``); the reference's oracle and the
    port take them."""
    j, t = both(qkv(2, S, S, 6, 2, 32, seed=S))
    o_r = rref.attention_ref(*j, causal=causal, window=window)
    o_p = tfa.flash_attention_plain(*t, causal=causal, window=window)
    close(o_p, o_r, F32_TOL)
    close(tops.attention(*t, causal=causal, window=window), o_r, F32_TOL)


def test_fully_masked_rows_give_zero_as_the_kernel_does():
    """A causal q_offset < 0 leaves the first rows no key: the reference's
    kernel gives 0 there (its oracle gives the mean of v), and so does the
    port's plain version."""
    j, t = both(qkv(1, 64, 64, 4, 2, 32, seed=7))
    o_r = rops.attention(*j, causal=True, q_offset=-40, impl="interpret",
                         block_q=64, block_k=64)
    o_p = tfa.flash_attention_plain(*t, causal=True, q_offset=-40)
    close(o_p, o_r, F32_TOL)
    assert not o_p[:, :40].any() and o_p[:, 40:].abs().sum() > 0
    o_o = tref.attention_ref(*t, causal=True, q_offset=-40)
    close(o_o[:, :40], t[2].mean(dim=1, keepdim=True).repeat_interleave(
        2, dim=2).expand(-1, 40, -1, -1), 1e-6)


def test_window_skips_nothing_it_should_keep():
    """Window and offset together (a decode-like block far from the start):
    the plain version against the oracle, with GQA 4."""
    j, t = both(qkv(1, 48, 300, 8, 2, 64, seed=11))
    o_r = rref.attention_ref(*j, causal=True, window=70, q_offset=252)
    o_p = tfa.flash_attention_plain(*t, causal=True, window=70, q_offset=252)
    close(o_p, o_r, F32_TOL)


# ---------------------------------------------------------------- oracles
def test_oracle_matches_reference_with_per_slot_offsets():
    """Per-slot q_offset (B,) and kv_positions (B, Skv) with negative
    (invalid) slots, in float32 and bf16, prefill and grouped decode."""
    r = np.random.RandomState(3)
    for Sq, bf16 in ((1, False), (5, False), (1, True), (5, True)):
        j, t = both(qkv(3, Sq, 24, 4, 2, 32, seed=Sq), bf16)
        qo = np.array([4, 17, 9], np.int32)
        kvp = (np.arange(24)[None, :] - r.randint(0, 6, (3, 1))).astype(
            np.int32)
        kvp[1, 3] = -1
        for window in (None, 8):
            o_r = rref.attention_ref(*j, causal=True, window=window,
                                     q_offset=jnp.asarray(qo),
                                     kv_positions=jnp.asarray(kvp))
            o_t = tref.attention_ref(*t, causal=True, window=window,
                                     q_offset=torch.from_numpy(qo),
                                     kv_positions=torch.from_numpy(kvp))
            assert o_t.dtype == t[0].dtype
            close(o_t, o_r, BF16_TOL if bf16 else REF_TOL)


def test_oracle_scalar_offset_and_shared_positions():
    j, t = both(qkv(2, 1, 16, 4, 1, 32, seed=5))
    kvp = np.array([8, 9, 10, 11, 12, 13, 14, 15, -8, -7, -6, -5, 4, 5, 6,
                    7], np.int32)
    o_r = rref.attention_ref(*j, causal=True, window=6, q_offset=13,
                             kv_positions=jnp.asarray(kvp))
    o_t = tref.attention_ref(*t, causal=True, window=6,
                             q_offset=torch.tensor(13),
                             kv_positions=torch.from_numpy(kvp))
    close(o_t, o_r, REF_TOL)


def test_chunked_oracle_matches_reference():
    j, t = both(qkv(1, 96, 96, 4, 2, 32, seed=9))
    qo = np.array([5], np.int32)
    o_r = rref.attention_ref_chunked(*j, causal=True, window=40,
                                     q_offset=jnp.asarray(qo), q_chunk=32)
    o_t = tref.attention_ref_chunked(*t, causal=True, window=40,
                                     q_offset=torch.from_numpy(qo),
                                     q_chunk=32)
    close(o_t, o_r, REF_TOL)
    close(o_t, tref.attention_ref(*t, causal=True, window=40,
                                  q_offset=torch.from_numpy(qo)), REF_TOL)
    # a length that is no multiple of the chunk runs as one chunk
    o_1 = tref.attention_ref_chunked(*t, causal=True, q_chunk=40)
    close(o_1, tref.attention_ref(*t, causal=True), REF_TOL)


# --------------------------------------------------------------- dispatch
@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = tfa.flash_attention

    def recorder(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention", recorder)
    return calls


def test_int_offset_goes_to_k5_and_tensor_offsets_to_ref(spy):
    _, t = both(qkv(1, 16, 16, 4, 2, 32, seed=1))
    tops.attention(*t, causal=True, window=8, q_offset=3)
    assert len(spy) == 1 and spy[0]["q_offset"] == 3 and spy[0]["window"] == 8
    o_t = tops.attention(*t, causal=True, q_offset=torch.tensor(3))
    o_k = tops.attention(*t, causal=True, kv_positions=torch.arange(16))
    assert len(spy) == 1  # both went to the oracle
    close(o_t, tref.attention_ref(*t, causal=True, q_offset=3), REF_TOL)
    close(o_k, tref.attention_ref(*t, causal=True), REF_TOL)
    tops.attention(*t, impl="plain")
    tops.attention(*t, impl="ref")
    assert len(spy) == 1
    with pytest.raises(ValueError, match="unknown impl"):
        tops.attention(*t, impl="interpret")


def test_ref_takes_the_chunked_oracle_for_long_prefills(monkeypatch):
    seen = []
    monkeypatch.setattr(tref, "attention_ref_chunked",
                        lambda *a, **k: seen.append(k) or "chunked")
    q = torch.zeros(1, 2048, 1, 32)
    kv = torch.zeros(1, 8192, 1, 32)
    assert tops.attention(q, kv, kv, impl="ref") == "chunked"
    assert tops.attention(q, kv, kv, q_offset=torch.tensor(0)) == "chunked"
    assert len(seen) == 2


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (q, k, v) = both(qkv(1, 8, 8, 4, 2, 32))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                            v[:, :, :1].expand(-1, -1, 3, -1).contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="all alike"):
        tfa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="Python int"):
        tfa.flash_attention(q, k, v, q_offset=torch.tensor(0))
    with pytest.raises(ValueError, match="positive int"):
        tfa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="no attention kernel for device "
                                         "meta"):
        tfa.flash_attention(*(a.to("meta") for a in (q, k, v)))
    with pytest.raises(ValueError, match=r"\(B, Sq, Hq, D\)"):
        tfa.flash_attention(q[0], k, v)


# ------------------------------------- K5's bf16 kernel, emulated on the CPU
def tensor_core_k5(q, k, v, causal, window, q_offset, split=True, block=64):
    """The arithmetic of ``flash_attention_sm90.cuh`` in plain torch, float32
    out: bf16 q . k summed in float32 and scaled after the product, 64-key
    tiles through the online softmax, the row sum l over the float32 p, and
    P carried to the P V product as bf16(p) + bf16(p - bf16(p)) (``split``)
    or as bf16(p) alone."""
    B, Sq, Hq, D = q.shape
    Skv, group = k.shape[1], Hq // k.shape[2]
    kf = k.float().repeat_interleave(group, 2)
    vf = v.float().repeat_interleave(group, 2).permute(0, 2, 1, 3)
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1 / math.sqrt(D))
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s_all = torch.where(mask, s_all, tfa.NEG_INF)
    m = torch.full((B, Hq, Sq, 1), tfa.NEG_INF)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Skv, block):
        s = s_all[..., k0:k0 + block]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alive = m_new > tfa.NEG_INF / 2
        alpha = torch.where(alive, torch.exp(m - m_new), 0.0)
        p = torch.where(alive, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
        vt = vf[:, :, k0:k0 + block]
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    return (acc / torch.where(l > 0, l, 1.0)).permute(0, 2, 1, 3)


def bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2 ** -126)))
                      - 7)


@pytest.mark.parametrize("case", CARD_CASES)
def test_tensor_core_arithmetic_meets_the_card_tolerance(case):
    """P split into two bf16 terms keeps the bf16 output within the card's
    tolerance of the plain version (and the float32 result within 2e-5 of
    the plain version in float32); P as one bf16 term does not."""
    *shape, causal, window, q_offset = case
    B, Sq, Skv, Hq, Hkv, D = shape
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in qkv(B, Sq, Skv, Hq, Hkv, D))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = tfa.flash_attention_plain(q, k, v, **kw).float()
    ref32 = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    allowed = CARD_TOL * (1 + ref.abs()) + bf16_ulp(ref)
    o32 = tensor_core_k5(q, k, v, causal, window, q_offset)
    o = o32.to(torch.bfloat16).float()
    assert bool(((o - ref).abs() <= allowed).all())
    assert bool(((o32 - ref32).abs() <= CARD_TOL * (1 + ref32.abs())).all())
    if q_offset < 0:
        assert not o[:, :-q_offset].any()
    single = tensor_core_k5(q, k, v, causal, window, q_offset, split=False)
    assert not bool(((single.to(torch.bfloat16).float() - ref).abs()
                     <= allowed).all())


# ------------------------------------------------- K5's TMA precondition
def test_tma_check_takes_contiguous_tensors():
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 37, 10, 256), (2, 5, 3, 32)):
            t = torch.zeros(shape, dtype=dtype)
            tfa.check_tma("q", t.data_ptr(), t.stride(), t.dtype)


@pytest.mark.parametrize("offset", [1, 3, 4, 7])
def test_tma_check_rejects_misaligned_views(offset):
    """A view whose data starts 2, 6, 8 or 14 bytes into a bf16 buffer."""
    buf = torch.zeros(64 + 2 * 8 * 4 * 64, dtype=torch.bfloat16)
    view = buf[offset:offset + 2 * 8 * 4 * 64].view(2, 8, 4, 64)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        tfa.check_tma("k", view.data_ptr(), view.stride(), view.dtype)
    aligned = buf[8:8 + 2 * 8 * 4 * 64].view(2, 8, 4, 64)
    tfa.check_tma("k", aligned.data_ptr(), aligned.stride(), aligned.dtype)


def test_tma_check_rejects_strides_off_16_bytes():
    t = torch.zeros(2, 8, 3, 36, dtype=torch.bfloat16)[..., :32]
    assert t.stride() == (864, 108, 36, 1)  # 72-byte rows
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tfa.check_tma("v", t.data_ptr(), t.stride(), t.dtype)
