"""PyTorch port: the arithmetic of bf16 B4's heads kernel (`csrc/knarpe_attn_heads.cuh`), on the CPU.

The kernel itself runs only on the card (tests/test_torch_knarpe_cuda.py and chip_smoke.py phase 3
hold it against its plain version there); its route, with the built library's answers faked, is
tested in tests/test_torch_knarpe.py. Here a torch emulation of one block's arithmetic (its quarter
of the heads: the 64 columns of q, k, v and out and of each half of W_rpe and the bias that belong to
two heads, and all of rpe; u, attn and y split into bf16 hi + lo operands; the logits' two halves of
the k steps summed in order; one rounding to bf16 at the output), the four quarters side by side, at
D=R=256, H=8, K in {5, 32, 40}, with an all-invalid and a one-target source, is held against
`knarpe_attention_reference` in float32 on the same bf16-valued inputs, at chip_smoke.py phase 3's
bf16 tolerance: half a bf16 ulp of the value (2^-8 relative) plus 1e-4 (the float32 tolerance, for
the other summation order). The same inputs also go through the JAX package's float32 reference
(`pallas_knarpe.knarpe_attention_reference`), to which the plain version agrees within 5e-6
(test_torch_knarpe.py's float32 tolerance). The plain version on one quarter's slices alone gives
the same columns as on the whole, within that tolerance: a block needs nothing from the other three.
Dropping the lo halves of the split operands exceeds the bf16 tolerance, so the emulation shows why
the kernel carries them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe

set_threads()
BF16_HALF_ULP, F32_ATOL, F32_REF_ATOL = 2.0 ** -8, 1e-4, 5e-6
N_BLOCKS = 4  # blocks per source, each on a quarter of the heads
SCALED = (256, 256, 8)  # the scaled preset's d_model, d_rpe, n_head


def _inputs(n_s, n_knn, d, r, seed):
    """B4 operands (numpy, float32 values that bf16 holds exactly): source 0 has no valid target, the last
    one a single valid target; weights scaled by 1/sqrt(fan-in), as chip_smoke.py's."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    inv = rng.uniform(size=(1, n_s, n_knn)) < 0.3
    inv[0, 0] = True
    inv[0, -1] = True
    inv[0, -1, n_knn // 2] = False
    args = dict(q=f(1, n_s, d), k=f(1, n_s, n_knn, d), v=f(1, n_s, n_knn, d), rpe=f(1, n_s, n_knn, r),
                invalid=inv, w_rpe=f(r, 2 * d, scale=r ** -0.5), b_rpe=f(2 * d, scale=0.1))
    return {k: v if v.dtype == bool else v.astype(jnp.bfloat16).astype(np.float32) for k, v in args.items()}


def _torch(args, dtype):
    return {k: torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(dtype) for k, v in args.items()}


def _split(x, lo=True):
    """bf16 hi + lo of float32 values, each as float32 (hi + lo keeps 16 significant bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(x))


def quarter_slices(q, k, v, w_rpe, b_rpe, qt: int):
    """Block qt's operands: the 64 columns of q, k and v of heads 2 qt, 2 qt + 1, and the same columns of
    each half ([W_k | W_v]) of W_rpe and of the bias."""
    d = q.shape[-1]
    cols = slice(qt * d // N_BLOCKS, (qt + 1) * d // N_BLOCKS)
    halves = lambda t: torch.cat([t[..., :d][..., cols], t[..., d:][..., cols]], -1)
    return q[..., cols], k[..., cols], v[..., cols], halves(w_rpe), halves(b_rpe)


def block_emulation(q, k, v, rpe, invalid, w, b, n_head: int, lo: bool = True) -> torch.Tensor:
    """One block's arithmetic on its quarter (q, k, v [.., DQ], w [R, 2 DQ], b [2 DQ]; rpe whole), in float32
    from bf16 operands, its sums in its order; lo=False drops the lo halves of the split operands.
    -> [B, S, DQ] float32, before the rounding to bf16."""
    n_b, n_s, n_knn, dq = k.shape
    dh = dq // n_head
    qf, kf, vf = q.float().reshape(-1, dq), k.float().reshape(-1, n_knn, dq), v.float().reshape(-1, n_knn, dq)
    x, inv = rpe.float().reshape(-1, n_knn, rpe.shape[-1]), invalid.reshape(-1, n_knn)
    w, b = w.float(), b.float()
    head = torch.arange(dq) // dh
    mask = (head[:, None] == torch.arange(n_head)[None, :]).float()  # [DQ, H]
    qh = qf[:, :, None] * mask  # the head-masked q [S, DQ, H]
    u_hi, u_lo = _split(w[None, :, :dq] @ qh, lo)  # u = W_k Q [S, R, H]
    c = (b[:dq] * qf).reshape(-1, n_head, dh).sum(-1)  # [S, H]
    kq = torch.einsum("sjd,sdh->sjh", kf, qh)  # k_jh . q_h [S, K, H]
    # the two halves of the k steps: rpe's first and second 128 columns, k's columns of head 0 and of head 1
    r_half = x.shape[-1] // 2
    halves = [x[:, :, sl] @ u_hi[:, sl] + x[:, :, sl] @ u_lo[:, sl]
              for sl in (slice(0, r_half), slice(r_half, None))]
    halves[0] = halves[0] + kq * (torch.arange(n_head) == 0).float()
    halves[1] = halves[1] + kq * (torch.arange(n_head) == 1).float()
    logits = ((halves[0] + halves[1] + c[:, None]) * (1.0 / dh ** 0.5)).transpose(1, 2)  # [S, H, K]
    masked = inv[:, None, :]
    m = torch.where(masked, -1e9, logits).amax(-1, keepdim=True)
    e = torch.where(masked, 0.0, torch.exp(logits - m))
    den = e.sum(-1, keepdim=True)
    no_valid = den[..., 0] <= 0
    attn = e / torch.where(den <= 0, 1.0, den)
    a_hi, a_lo = _split(attn, lo)
    y_hi, y_lo = _split(a_hi @ x + a_lo @ x, lo)  # y^T = rpe^T [A_hi; A_lo]^T, hi and lo columns summed [S, H, R]
    wv = w[:, dq:]
    out = (y_hi @ wv + y_lo @ wv)[:, head, torch.arange(dq)]  # [Y_hi | Y_lo] W_v, head h(d)'s columns kept
    out = out + torch.einsum("shj,sjd->shd", a_hi + a_lo, vf)[:, head, torch.arange(dq)]
    out = out + b[dq:] * attn.sum(-1)[:, head]
    out = torch.where(no_valid[:, head], 0.0, out)
    return out.reshape(n_b, n_s, dq)


def heads_emulation(q, k, v, rpe, invalid, w_rpe, b_rpe, n_head: int, lo: bool = True) -> torch.Tensor:
    """The four blocks of a source side by side, each from its own quarter alone, one rounding to bf16.
    -> [B, S, D] bf16."""
    outs = []
    for qt in range(N_BLOCKS):
        q_q, k_q, v_q, w_q, b_q = quarter_slices(q, k, v, w_rpe, b_rpe, qt)
        outs.append(block_emulation(q_q, k_q, v_q, rpe, invalid, w_q, b_q, n_head // N_BLOCKS, lo))
    return torch.cat(outs, -1).to(torch.bfloat16)


def _excess(got, ref):
    """How far |got - ref| exceeds phase 3's bf16 tolerance, 2^-8 |ref| + 1e-4, at its worst (<= 0: within)."""
    return float(((got - ref).abs() - (BF16_HALF_ULP * ref.abs() + F32_ATOL)).max())


@pytest.mark.parametrize("n_knn", [5, 32, 40])
def test_heads_arithmetic_matches_the_plain_version(n_knn):
    """The emulated kernel at D=R=256, H=8 within phase 3's bf16 tolerance of the float32 plain version on the
    same bf16-valued inputs; the all-invalid source exactly zero; the plain version within 5e-6 of the JAX
    package's float32 reference."""
    d, r, n_head = SCALED
    args = _inputs(6, n_knn, d, r, seed=n_knn)
    t16, t32 = _torch(args, torch.bfloat16), _torch(args, torch.float32)
    got = heads_emulation(*t16.values(), n_head).float()
    ref = knarpe.knarpe_attention_reference(*t32.values(), n_head)
    assert got.shape == ref.shape == (1, 6, d) and torch.isfinite(got).all()
    assert _excess(got, ref) <= 0
    assert torch.all(got[0, 0] == 0) and torch.all(ref[0, 0] == 0)
    j = {k: jnp.asarray(v) for k, v in args.items()}
    want = np.asarray(jk.knarpe_attention_reference(*j.values(), n_head), dtype=np.float32).reshape(1, 6, d)
    np.testing.assert_allclose(t2n(ref), want, rtol=0, atol=F32_REF_ATOL)


@pytest.mark.parametrize("qt", range(N_BLOCKS))
def test_each_quarter_needs_only_its_own_slices(qt):
    """The no-exchange claim the kernel rests on: the float32 plain version on one quarter's slices alone (its
    64 columns of q, k, v, W_k, W_v and the bias, two heads, all of rpe) gives that quarter's columns of the
    plain version on the whole, within the float32 tolerance (summation order of smaller products only)."""
    d, r, n_head = SCALED
    t = _torch(_inputs(6, 32, d, r, seed=7), torch.float32)
    whole = knarpe.knarpe_attention_reference(*t.values(), n_head)
    q, k, v, w, b = quarter_slices(t["q"], t["k"], t["v"], t["w_rpe"], t["b_rpe"], qt)
    part = knarpe.knarpe_attention_reference(q, k, v, t["rpe"], t["invalid"], w, b, n_head // N_BLOCKS)
    dq = d // N_BLOCKS
    torch.testing.assert_close(part, whole[..., qt * dq:(qt + 1) * dq], rtol=0, atol=F32_REF_ATOL)


def test_heads_arithmetic_needs_the_lo_halves():
    """Without the lo halves of u, attn and y (bf16 operands alone, 8 significant bits) the emulation
    leaves phase 3's tolerance: the split is what keeps the kernel at float32 level."""
    d, r, n_head = SCALED
    args = _inputs(6, 32, d, r, seed=32)
    t16, t32 = _torch(args, torch.bfloat16), _torch(args, torch.float32)
    ref = knarpe.knarpe_attention_reference(*t32.values(), n_head)
    assert _excess(heads_emulation(*t16.values(), n_head).float(), ref) <= 0
    assert _excess(heads_emulation(*t16.values(), n_head, lo=False).float(), ref) > 0
