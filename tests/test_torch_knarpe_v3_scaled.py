"""PyTorch port: the arithmetic of bf16 B3's heads kernel (`csrc/knarpe_v3_heads.cuh`) and the ported bench, on the CPU.

The kernel itself runs only on the card (tests/test_torch_knarpe_cuda.py and chip_smoke.py phase 3 hold it
against its plain version there); its route, with the built library's answers faked, is tested in
tests/test_torch_knarpe.py. Here a torch emulation of the kernel's per-source arithmetic as it orders it (four
blocks per source, each on two heads with its 64 columns of [W_k; W_rpe,k] and [W_v; W_rpe,v]; kk from bf16
products summed in float32, + b_k and rounded to bf16, q * kk rounded to bf16, the 32 products of a head summed
in float32; the targets in tiles of 32 with the softmax taken online over them (each tile's max, exp(logit - tile
max) and their sum, then rescaled by exp(tile max - running max)), p split into bf16 hi + lo for
y = sum_j p_j x_j; y split again for y W_v, the four y warps' partial outputs summed in warp order; one rounding
to bf16 at the output) at D=R=256, H=8, K in {5, 89}, with an all-invalid and a one-target source, is held against
`knarpe_cross_attention_v3_reference` in bf16 at chip_smoke.py phase 3's B3 tolerance: one bf16 ulp (2^-7)
relative plus 2^-8 of the largest output, and a mean |err| under a quarter of the plain version's distance from
the unrounded (float32) result. The same emulation with kk's rounding left out fails that mean check, so the check
sees the roundings. The plain version is held against the JAX package's `knarpe_cross_attention_v3` in interpret
mode at these widths on a few sources, as tests/test_torch_knarpe.py does at the small widths: within 3.2e-2, one
bf16 ulp at |out| < 8 (measured 4.9e-4 at |out| up to 4.3), and closer to it than B2's plain version (1.6e-2). The
emulation's mean error is 0.03-0.16 % of the roundings' own, and 65-81 % of it without kk's rounding.

`utils/bench_knarpe.py`, the port of `scripts/bench_knarpe.py`, runs on the CPU with `device="cpu"` (the plain
versions) at the scaled shape's widths cut to one of its 128 batches: three variants, their routes, a JSON line
last; without a card and that request it raises.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe
from trafficbotsv15_tpu_torch.utils import bench_knarpe

set_threads()
BF16_ULP, BF16_V3_ATOL = 2.0 ** -7, 3.2e-2
N_BLOCKS, TILE, Y_WARPS = 4, 32, 4  # blocks per source (two heads each), targets per tile, warps taking y
SCALED = (256, 256, 8)  # the scaled preset's d_model, d_rpe, n_head


def _inputs(n_s, n_knn, d, r, seed):
    """B3 operands (numpy, float32 values that bf16 holds exactly): source 0 has no valid target, the last one a
    single valid target; weights scaled by 1/sqrt(fan-in), as chip_smoke.py's."""
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


def _split(x):
    """bf16 hi + lo of float32 values, each as float32 (hi + lo keeps 16 significant bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _round(x):
    return x.to(torch.bfloat16).float()


def heads_emulation(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int, round_kk: bool = True) -> torch.Tensor:
    """The heads kernel's arithmetic per source, in float32 from bf16 operands, its sums in its order; with
    round_kk=False kk is left unrounded. -> [B, S, D] bf16."""
    n_b, n_s, n_knn, d = tgt.shape
    dq, dh = d // N_BLOCKS, d // n_head
    x = torch.cat([tgt.float(), rpe.float()], -1).reshape(-1, n_knn, 2 * d)  # [S, K, X]
    w = torch.cat([w_kv.float(), w_rpe.float()], 0)  # [X, 2D]
    qf, bias, inv = q.float().reshape(-1, d), b.float(), invalid.reshape(-1, n_knn)
    n_src, ycols = x.shape[0], x.shape[-1] // Y_WARPS
    out = torch.empty(n_src, d)
    for qt in range(N_BLOCKS):  # block qt: heads 2 qt, 2 qt + 1, columns cols of k, v and out
        cols = slice(dq * qt, dq * (qt + 1))
        kk = x @ w[:, cols] + bias[cols]  # exact bf16 products, float32 sums
        if round_kk:
            kk = _round(kk)
        prod = _round(qf[:, None, cols] * kk)  # [S, K, 64]
        logits = prod.reshape(n_src, n_knn, dq // dh, dh).sum(-1) / dh ** 0.5  # [S, K, 2]
        m = torch.full((n_src, 2), -float("inf"))
        den = torch.zeros(n_src, 2)
        y_hi_part = torch.zeros(n_src, 2, x.shape[-1])  # rows hi and lo of P x, kept apart as the kernel's rows
        y_lo_part = torch.zeros(n_src, 2, x.shape[-1])
        for t0 in range(0, n_knn, TILE):  # the online softmax over tiles of 32 targets
            tile = slice(t0, min(t0 + TILE, n_knn))
            masked = inv[:, tile, None]
            lt = logits[:, tile]
            m_t = torch.where(masked, -1e9, lt).amax(1)  # the tile's max, exp(logit - m_t) and their sum [S, 2]
            p_t = torch.where(masked, 0.0, torch.exp(lt - m_t[:, None]))
            m_new = torch.maximum(m, m_t)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_t - m_new)
            den = den * alpha + p_t.sum(1) * beta
            p = p_t * beta[:, None]  # [S, tile, 2]
            m = m_new
            p_hi, p_lo = _split(p.transpose(1, 2))  # [S, 2, tile]
            y_hi_part = y_hi_part * alpha[..., None] + p_hi @ x[:, tile]
            y_lo_part = y_lo_part * alpha[..., None] + p_lo @ x[:, tile]
        y_hi, y_lo = _split(y_hi_part + y_lo_part)  # [S, 2, X]
        wv = w[:, d + dq * qt:d + dq * (qt + 1)]  # [X, 64]
        head = torch.arange(dq) // dh
        parts = [(y_hi[..., sl] @ wv[sl] + y_lo[..., sl] @ wv[sl])[:, head, torch.arange(dq)]
                 for sl in (slice(ycols * yw, ycols * (yw + 1)) for yw in range(Y_WARPS))]
        o = parts[0]
        for part in parts[1:]:
            o = o + part
        den_d = den[:, head]
        out[:, cols] = torch.where(den_d > 0, o / torch.where(den_d > 0, den_d, 1.0) + bias[d + dq * qt:][:dq], 0.0)
    return out.to(torch.bfloat16).reshape(n_b, n_s, d)


def _errors(got, t16, t32, n_head):
    """(excess over phase 3's B3 tolerance, mean |err|, mean |plain bf16 - unrounded|) against the plain version."""
    ref16 = knarpe.knarpe_cross_attention_v3_reference(*t16.values(), n_head).float()
    ref32 = knarpe.knarpe_cross_attention_v3_reference(*t32.values(), n_head)
    atol = 2.0 ** -8 * float(ref16.abs().max())
    excess = float(((got - ref16).abs() - (BF16_ULP * ref16.abs() + atol)).max())
    return excess, float((got - ref16).abs().mean()), float((ref32 - ref16).abs().mean())


@pytest.mark.parametrize("n_knn", [5, 89])
def test_heads_arithmetic_matches_the_plain_version(n_knn):
    """The emulated kernel at D=R=256, H=8 within phase 3's B3 tolerance of the bf16 plain version, its mean error
    under a quarter of the roundings' own; the all-invalid source exactly zero."""
    d, r, n_head = SCALED
    args = _inputs(6, n_knn, d, r, seed=n_knn)
    t16, t32 = _torch(args, torch.bfloat16), _torch(args, torch.float32)
    got = heads_emulation(*t16.values(), n_head).float()
    assert got.shape == (1, 6, d) and torch.isfinite(got).all()
    excess, mean_err, mean_unrounded = _errors(got, t16, t32, n_head)
    assert excess <= 0
    assert mean_err <= 0.25 * mean_unrounded
    assert torch.all(got[0, 0] == 0)


def test_heads_arithmetic_fails_the_mean_check_without_the_kk_rounding():
    """Leaving kk's rounding out of the emulation (q * kk still rounded) puts its mean error above a quarter of
    the roundings' own: phase 3's mean check sees a kernel that skips it."""
    d, r, n_head = SCALED
    args = _inputs(6, 89, d, r, seed=89)
    t16, t32 = _torch(args, torch.bfloat16), _torch(args, torch.float32)
    _, mean_err, mean_unrounded = _errors(heads_emulation(*t16.values(), n_head).float(), t16, t32, n_head)
    assert mean_err <= 0.25 * mean_unrounded
    _, mean_err, mean_unrounded = _errors(heads_emulation(*t16.values(), n_head, round_kk=False).float(), t16, t32,
                                          n_head)
    assert mean_err > 0.25 * mean_unrounded


def test_plain_version_matches_the_tpu_kernel_at_the_scaled_widths():
    """In bf16 at D=R=256, H=8 the v3 plain version is within one bf16 ulp at |out| < 8 of the Pallas v3 kernel in
    interpret mode, and closer to it than B2's plain version: it repeats the kernel's roundings and nothing else."""
    d, r, n_head = SCALED
    args = _inputs(4, 89, d, r, seed=7)
    j = {k: jnp.asarray(v) if v.dtype == bool else jnp.asarray(v).astype(jnp.bfloat16) for k, v in args.items()}
    t = _torch(args, torch.bfloat16)
    want = np.asarray(jk.knarpe_cross_attention_v3(*j.values(), n_head, interpret=True), np.float32).reshape(1, 4, d)
    got = t2n(knarpe.knarpe_cross_attention_v3_reference(*t.values(), n_head))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_V3_ATOL)
    np.testing.assert_array_equal(got[0, 0], 0.0)
    err_v3 = np.abs(got - want).max()
    err_v2 = np.abs(t2n(knarpe.knarpe_cross_attention_reference(*t.values(), n_head)) - want).max()
    assert err_v3 < err_v2


def test_bench_runs_the_three_variants_on_the_cpu(capsys, monkeypatch):
    """`bench_knarpe.run` with device="cpu" at the scaled shape's widths, one of its 128 batches: the three
    variants of scripts/bench_knarpe.py (the library composition, B2, B3) on their routes, each within 2^-4 of
    the library output relative to its largest magnitude, the device line first and the JSON line last."""
    monkeypatch.setitem(bench_knarpe.SHAPES, "scaled", (1, *bench_knarpe.SHAPES["scaled"][1:]))
    result = bench_knarpe.run("scaled", iters=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu") and json.loads(lines[-1]) == result and len(lines) == 5
    assert result["dims"] == [1, 64, 89, 256, 256, 8]
    assert [(v["variant"], v["route"]) for v in result["variants"]] == [
        ("library_fullwidth", "library"), ("knarpe_v2", "plain"), ("knarpe_v3", "plain")]
    assert result["variants"][0]["rel_err"] == 0
    assert all(0 < v["rel_err"] <= 2.0 ** -4 and v["ms"] > 0 for v in result["variants"][1:])


def test_bench_raises_without_a_card(monkeypatch):
    """The bench runs on the card unless the caller asks for the CPU: without one it raises, printing nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_knarpe.main(["--shape", "scaled"])
