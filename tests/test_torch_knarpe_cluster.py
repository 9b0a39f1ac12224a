"""PyTorch port: the arithmetic of bf16 B2's cluster kernel (`csrc/knarpe_cluster.cuh`), on the CPU.

The kernel itself runs only on the card (tests/test_torch_knarpe_cuda.py and chip_smoke.py phase 3
hold it against its plain version there); its route, with the built library's answers faked, is
tested in tests/test_torch_knarpe.py. Here a torch emulation of the kernel's per-source sums as it
orders them (the four X-quarters of [tgt | rpe], u, attn and y split into bf16 hi + lo operands, the
partial logits and partial outputs summed in rank order, one rounding to bf16 at the output) at
D=R=256, H=8, K in {5, 89}, with an all-invalid and a one-target source, is held against
`knarpe_cross_attention_reference` in float32 on the same bf16-valued inputs, at chip_smoke.py phase
3's bf16 tolerance: half a bf16 ulp of the value (2^-8 relative) plus 1e-4 (the float32 tolerance,
for the other summation order). The same inputs also go through the JAX package's float32 reference
(`pallas_knarpe.knarpe_cross_attention_reference`), to which the plain version agrees within 5e-6
(test_torch_knarpe.py's float32 tolerance). Dropping the lo halves of the split operands exceeds that
tolerance, so the emulation shows why the kernel carries them.
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
N_BLOCKS = 4  # blocks of a cluster, each on a quarter of [tgt | rpe]
SCALED = (256, 256, 8)  # the scaled preset's d_model, d_rpe, n_head


def _inputs(n_s, n_knn, d, r, seed):
    """B2 operands (numpy, float32 values that bf16 holds exactly): source 0 has no valid target, the last
    one a single valid target; weights scaled by 1/sqrt(fan-in), as chip_smoke.py's."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    inv = rng.uniform(size=(1, n_s, n_knn)) < 0.3
    inv[0, 0] = True
    inv[0, -1] = True
    inv[0, -1, n_knn // 2] = False
    args = dict(q=f(1, n_s, d), tgt=f(1, n_s, n_knn, d), rpe=f(1, n_s, n_knn, r), invalid=inv,
                w_kv=f(d, 2 * d, scale=d ** -0.5), w_rpe=f(r, 2 * d, scale=r ** -0.5), b=f(2 * d, scale=0.1))
    return {k: v if v.dtype == bool else v.astype(jnp.bfloat16).astype(np.float32) for k, v in args.items()}


def _torch(args, dtype):
    return {k: torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(dtype) for k, v in args.items()}


def _split(x, lo=True):
    """bf16 hi + lo of float32 values, each as float32 (hi + lo keeps 16 significant bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(x))


def cluster_emulation(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int, lo: bool = True) -> torch.Tensor:
    """The cluster kernel's arithmetic per source, in float32 from bf16 operands, its sums in its order;
    lo=False drops the lo halves of the split operands. -> [B, S, D] bf16."""
    n_b, n_s, n_knn, d = tgt.shape
    x_all = d + rpe.shape[-1]
    xq, dh = x_all // N_BLOCKS, d // n_head
    x = torch.cat([tgt.float(), rpe.float()], -1).reshape(-1, n_knn, x_all)  # [S, K, X]
    w = torch.cat([w_kv.float(), w_rpe.float()], 0)  # [X, 2D]
    qf, bias, inv = q.float().reshape(-1, d), b.float(), invalid.reshape(-1, n_knn)
    head = torch.arange(d) // dh
    qh = qf[:, :, None] * (head[:, None] == torch.arange(n_head)[None, :]).float()  # the head-masked q [S, D, H]
    u_hi, u_lo = _split(w[None, :, :d] @ qh, lo)  # u = W_k Q [S, X, H]
    c = (bias[:d] * qf).reshape(-1, n_head, dh).sum(-1)  # [S, H]
    quarters = [slice(r * xq, (r + 1) * xq) for r in range(N_BLOCKS)]
    # block r's partial logits x[:, quarter] [U_hi | U_lo], summed in rank order
    parts = [x[:, :, sl] @ u_hi[:, sl] + x[:, :, sl] @ u_lo[:, sl] for sl in quarters]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    logits = ((total + c[:, None]) * (1.0 / dh ** 0.5)).transpose(1, 2)  # [S, H, K]
    masked = inv[:, None, :]
    m = torch.where(masked, -1e9, logits).amax(-1, keepdim=True)
    e = torch.where(masked, 0.0, torch.exp(logits - m))
    den = e.sum(-1, keepdim=True)
    no_valid = den[..., 0] <= 0
    attn = e / torch.where(den <= 0, 1.0, den)
    a_hi, a_lo = _split(attn, lo)
    y_hi, y_lo = _split(a_hi @ x + a_lo @ x, lo)  # y = [A_hi; A_lo] x, rows hi and lo summed [S, H, X]
    wv = w[:, d:]
    # block r's partial out [Y_hi; Y_lo] W_v[quarter] (the rows of head h(d) kept), summed in rank order
    outs = [(y_hi[:, :, sl] @ wv[sl] + y_lo[:, :, sl] @ wv[sl])[:, head, torch.arange(d)] for sl in quarters]
    out = outs[0]
    for part in outs[1:]:
        out = out + part
    out = out + bias[d:] * attn.sum(-1)[:, head]
    out = torch.where(no_valid[:, head], 0.0, out)
    return out.to(torch.bfloat16).reshape(n_b, n_s, d)


def _excess(got, ref):
    """How far |got - ref| exceeds phase 3's bf16 tolerance, 2^-8 |ref| + 1e-4, at its worst (<= 0: within)."""
    return float(((got - ref).abs() - (BF16_HALF_ULP * ref.abs() + F32_ATOL)).max())


@pytest.mark.parametrize("n_knn", [5, 89])
def test_cluster_arithmetic_matches_the_plain_version(n_knn):
    """The emulated kernel at D=R=256, H=8 within phase 3's bf16 tolerance of the float32 plain version on
    the same bf16-valued inputs; the all-invalid source exactly zero, the one-target source its target's v;
    the plain version within 5e-6 of the JAX package's float32 reference."""
    d, r, n_head = SCALED
    args = _inputs(6, n_knn, d, r, seed=n_knn)
    t16, t32 = _torch(args, torch.bfloat16), _torch(args, torch.float32)
    got = cluster_emulation(*t16.values(), n_head).float()
    ref = knarpe.knarpe_cross_attention_reference(*t32.values(), n_head)
    assert got.shape == ref.shape == (1, 6, d) and torch.isfinite(got).all()
    assert _excess(got, ref) <= 0
    assert torch.all(got[0, 0] == 0) and torch.all(ref[0, 0] == 0)
    j = {k: jnp.asarray(v) for k, v in args.items()}
    want = np.asarray(jk.knarpe_cross_attention_reference(*j.values(), n_head), dtype=np.float32).reshape(1, 6, d)
    np.testing.assert_allclose(t2n(ref), want, rtol=0, atol=F32_REF_ATOL)


def test_cluster_arithmetic_needs_the_lo_halves():
    """Without the lo halves of u, attn and y (bf16 operands alone, 8 significant bits) the emulation
    leaves phase 3's tolerance: the split is what keeps the kernel at float32 level."""
    d, r, n_head = SCALED
    args = _inputs(6, 89, d, r, seed=89)
    t16, t32 = _torch(args, torch.bfloat16), _torch(args, torch.float32)
    ref = knarpe.knarpe_cross_attention_reference(*t32.values(), n_head)
    assert _excess(cluster_emulation(*t16.values(), n_head).float(), ref) <= 0
    assert _excess(cluster_emulation(*t16.values(), n_head, lo=False).float(), ref) > 0
