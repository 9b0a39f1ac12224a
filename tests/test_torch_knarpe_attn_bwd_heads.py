"""PyTorch port: the arithmetic of bf16 B4-bwd's heads kernel (`csrc/knarpe_attn_bwd_heads.cuh`), on the CPU.

The kernel itself runs only on the card (tests/test_torch_knarpe_cuda.py and chip_smoke.py phase 3 hold it
against autograd of its plain version there); its route, with the built library's answers faked, is tested in
tests/test_torch_knarpe_grad.py. Here a torch emulation of one block's backward arithmetic (its quarter of the
heads: the 64 columns of q, g, k, v, dq, dk and dv and of each half of W_rpe and the bias that belong to two heads,
and all of rpe; u, w, scale dl, attn and z' split into bf16 hi + lo operands; the logits' two halves of the k steps
summed in order; its rows of pbuf and its drpe factors F = [scale dl | attn], G = [u | w]), the four blocks side
by side, drpe formed from the sixteen factor columns in block order and the weight gradients from pbuf, one rounding
to bf16 at each output, at D=R=256, H=8, K in {5, 32, 40}, with an all-invalid and a one-target source, is held
against `knarpe_attention_bwd_reference` in float32 on the same bf16-valued inputs at chip_smoke.py phase 3's bf16
tolerance: 2^-8 of each value plus 1e-4 of each gradient's largest magnitude. The same inputs also go through the
JAX package's backward kernel (`pallas_knarpe._knarpe_bwd_pallas`) in interpret mode, to which the plain backward
agrees within test_torch_knarpe_grad.py's float32 tolerance (5e-5 absolute plus 1e-5 relative). The plain backward
on one quarter's slices alone gives that quarter's columns of dq, dk, dv and of the weight gradients, and its drpe
is that quarter's share: the four shares sum to the whole drpe, within the float32 tolerance. Dropping the lo
halves of the split operands exceeds the bf16 tolerance, so the emulation shows why the kernel carries them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe

set_threads()
BF16_HALF_ULP, BWD_REL, F32_ATOL, F32_RTOL = 2.0 ** -8, 1e-4, 5e-5, 1e-5
N_BLOCKS = 4  # blocks per source, each on a quarter of the heads
SCALED = (256, 256, 8)  # the scaled preset's d_model, d_rpe, n_head
N_SRC = 6
NAMES = ("dq", "dk", "dv", "drpe", "dw_rpe", "db_rpe")


def _inputs(n_s, n_knn, d, r, seed):
    """B4 operands and the incoming gradient g (numpy, float32 values that bf16 holds exactly): source 0 has no
    valid target, the last one a single valid target; weights scaled by 1/sqrt(fan-in), as chip_smoke.py's."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    inv = rng.uniform(size=(1, n_s, n_knn)) < 0.3
    inv[0, 0] = True
    inv[0, -1] = True
    inv[0, -1, n_knn // 2] = False
    args = dict(q=f(1, n_s, d), k=f(1, n_s, n_knn, d), v=f(1, n_s, n_knn, d), rpe=f(1, n_s, n_knn, r),
                invalid=inv, w_rpe=f(r, 2 * d, scale=r ** -0.5), b_rpe=f(2 * d, scale=0.1), g=f(1, n_s, d))
    return {k: v if v.dtype == bool else v.astype(jnp.bfloat16).astype(np.float32) for k, v in args.items()}


def _torch(args):
    return {k: torch.from_numpy(v) for k, v in args.items()}


def _split(x, lo=True):
    """bf16 hi + lo of float32 values, each as float32 (hi + lo keeps 16 significant bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(x))


def quarter_slices(t: dict, qt: int) -> dict:
    """Block qt's operands: the 64 columns of q, g, k and v of heads 2 qt, 2 qt + 1, the same columns of each half
    ([W_k | W_v]) of W_rpe and of the bias; rpe and the mask whole."""
    d = t["q"].shape[-1]
    cols = slice(qt * d // N_BLOCKS, (qt + 1) * d // N_BLOCKS)
    halves = lambda x: torch.cat([x[..., :d][..., cols], x[..., d:][..., cols]], -1)
    return dict(q=t["q"][..., cols], k=t["k"][..., cols], v=t["v"][..., cols], rpe=t["rpe"], invalid=t["invalid"],
                w_rpe=halves(t["w_rpe"]), b_rpe=halves(t["b_rpe"]), g=t["g"][..., cols])


def block_emulation(t: dict, n_head: int, scale: float, lo: bool = True) -> dict:
    """One block's arithmetic on its quarter (`quarter_slices`; n_head its two heads), in float32 from bf16 operands;
    lo=False drops the lo halves of the split operands. -> dq [S, DQ], dk, dv [S, K, DQ] before the rounding to bf16,
    its pbuf rows zk [S, H', R + 1] (k half: z', scale sum dl) and yv (v half: y, sum attn), F [S, K, 2 H'] and
    G [S, 2 H', R]."""
    q, g = t["q"].reshape(-1, t["q"].shape[-1]), t["g"].reshape(-1, t["q"].shape[-1])
    n_knn, dq = t["k"].shape[2], q.shape[-1]
    k, v = t["k"].reshape(-1, n_knn, dq), t["v"].reshape(-1, n_knn, dq)
    x, inv = t["rpe"].reshape(-1, n_knn, t["rpe"].shape[-1]), t["invalid"].reshape(-1, n_knn)
    w, b = t["w_rpe"], t["b_rpe"]
    dh = dq // n_head
    head = torch.arange(dq) // dh
    mask = (head[:, None] == torch.arange(n_head)[None, :]).float()  # [DQ, H']
    qh, gh = q[:, :, None] * mask, g[:, :, None] * mask  # the head-masked q and g [S, DQ, H']
    u, wv = w[None, :, :dq] @ qh, w[None, :, dq:] @ gh  # [u | w] = W_k Q + W_v G [S, R, H']
    u_hi, u_lo = _split(u, lo)
    w_hi, w_lo = _split(wv, lo)
    c = (b[:dq] * q).reshape(-1, n_head, dh).sum(-1)  # b_k,h . q_h [S, H']
    e = (b[dq:] * g).reshape(-1, n_head, dh).sum(-1)  # b_v,h . g_h
    # the two halves of the k steps: rpe's first 128 columns and k . Q, rpe's last 128 and v . G
    r_half = x.shape[-1] // 2
    parts = []
    for sl in (slice(0, r_half), slice(r_half, None)):
        xs = x[:, :, sl]
        parts.append((xs @ u_hi[:, sl] + xs @ u_lo[:, sl], xs @ w_hi[:, sl] + xs @ w_lo[:, sl]))
    lgt = parts[0][0] + torch.einsum("sjd,sdh->sjh", k, qh) + parts[1][0]
    dattn = parts[0][1] + parts[1][1] + torch.einsum("sjd,sdh->sjh", v, gh)
    logits = ((lgt + c[:, None]) * scale).transpose(1, 2)  # [S, H', K]
    dattn = (dattn + e[:, None]).transpose(1, 2)
    masked = inv[:, None, :]
    m = torch.where(masked, -1e9, logits).amax(-1, keepdim=True)
    ex = torch.where(masked, 0.0, torch.exp(logits - m))
    den = ex.sum(-1, keepdim=True)
    attn = ex / torch.where(den <= 0, 1.0, den)
    sdl = scale * (attn * (dattn - (attn * dattn).sum(-1, keepdim=True)))  # scale dl [S, H', K]
    s_hi, s_lo = _split(sdl, lo)
    a_hi, a_lo = _split(attn, lo)
    z = s_hi @ x + s_lo @ x  # z' = sum_j scale dl_j rpe_j [S, H', R]
    y = a_hi @ x + a_lo @ x
    z_hi, z_lo = _split(z, lo)
    wk = w[:, :dq]
    cols = torch.arange(dq)
    dq_out = (z_hi @ wk + z_lo @ wk)[:, head, cols]  # W_k^T [Z_hi | Z_lo], head h(d)'s column kept
    dq_out = dq_out + torch.einsum("shj,sjd->shd", s_hi + s_lo, k)[:, head, cols]
    dq_out = dq_out + b[:dq] * sdl.sum(-1)[:, head]
    dk = sdl.transpose(1, 2)[:, :, head] * q[:, None, :]
    dv = attn.transpose(1, 2)[:, :, head] * g[:, None, :]
    return dict(dq=dq_out, dk=dk, dv=dv, zk=torch.cat([z, sdl.sum(-1, keepdim=True)], -1),
                yv=torch.cat([y, attn.sum(-1, keepdim=True)], -1), F=torch.cat([sdl, attn], 1).transpose(1, 2),
                G=torch.cat([u, wv], -1).transpose(1, 2))


def heads_bwd_emulation(t: dict, n_head: int, lo: bool = True):
    """The four blocks of a source side by side, each from its own quarter alone; drpe = F G over the sixteen factor
    columns in block order, the weight gradients from pbuf's rows (P^T [q | g], the bias from row R), each rounded
    once to bf16. -> (dq, dk, dv, drpe, dw_rpe, db_rpe) as float32 values of bf16."""
    n_b, n_s, n_knn, d = t["k"].shape
    scale = 1.0 / (d // n_head) ** 0.5
    blocks = [block_emulation(quarter_slices(t, qt), n_head // N_BLOCKS, scale, lo) for qt in range(N_BLOCKS)]
    cat = lambda key: torch.cat([blk[key] for blk in blocks], -1)
    f_cols = torch.cat([blk["F"] for blk in blocks], -1)  # [S, K, 16]
    g_rows = torch.cat([blk["G"] for blk in blocks], 1)  # [S, 16, R]
    drpe = torch.zeros(f_cols.shape[0], n_knn, g_rows.shape[-1])
    for col in range(f_cols.shape[-1]):  # the drpe pass's order
        drpe = drpe + f_cols[:, :, col, None] * g_rows[:, None, col, :]
    zk = torch.cat([blk["zk"] for blk in blocks], 1)  # pbuf's k half [S, H, R + 1]
    yv = torch.cat([blk["yv"] for blk in blocks], 1)  # and its v half
    dh = d // n_head
    q, g = t["q"].reshape(-1, n_head, dh), t["g"].reshape(-1, n_head, dh)
    dw_k = torch.einsum("shi,shd->ihd", zk, q).reshape(-1, d)  # [R + 1, D]: row R is the bias
    dw_v = torch.einsum("shi,shd->ihd", yv, g).reshape(-1, d)
    dw = torch.cat([dw_k, dw_v], -1)
    r16 = lambda x: x.to(torch.bfloat16).float()
    return (r16(cat("dq")).reshape(n_b, n_s, d), r16(cat("dk")).reshape(n_b, n_s, n_knn, d),
            r16(cat("dv")).reshape(n_b, n_s, n_knn, d), r16(drpe).reshape(n_b, n_s, n_knn, -1), r16(dw[:-1]),
            r16(dw[-1]))


def _excess(got, ref):
    """How far |got - ref| exceeds phase 3's bf16 tolerance, 2^-8 |ref| + 1e-4 max |ref|, at its worst (<= 0: within)."""
    return float(((got - ref).abs() - (BF16_HALF_ULP * ref.abs() + BWD_REL * float(ref.abs().max()))).max())


def _plain(t: dict, n_head: int):
    ops = [t[k] for k in ("q", "k", "v", "rpe", "invalid", "w_rpe", "b_rpe")]
    return knarpe.knarpe_attention_bwd_reference(*ops, t["g"], n_head)


@pytest.mark.parametrize("n_knn", [5, 32, 40])
def test_heads_bwd_arithmetic_matches_the_plain_backward(n_knn):
    """The emulated kernel at D=R=256, H=8 within phase 3's bf16 tolerance of the float32 plain backward on the same
    bf16-valued inputs, every gradient; the all-invalid source's dq, dk, dv and drpe exactly zero."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, n_knn, d, r, seed=100 + n_knn))
    got, want = heads_bwd_emulation(t, n_head), _plain(t, n_head)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _excess(a, b) <= 0, name
    assert all(torch.all(x[0, 0] == 0) for x in got[:4]) and all(torch.all(x[0, 0] == 0) for x in want[:4])


@pytest.mark.parametrize("n_knn", [5, 32, 40])
def test_plain_backward_matches_the_tpu_kernel_at_the_scaled_widths(n_knn):
    """The plain backward against the JAX package's `_knarpe_bwd_pallas` in interpret mode on the same inputs at
    D=R=256, H=8 (source tiles of 4 over 6 sources: no multiple of the tile), to test_torch_knarpe_grad.py's float32
    tolerance."""
    d, r, n_head = SCALED
    args = _inputs(N_SRC, n_knn, d, r, seed=100 + n_knn)
    j = [jnp.asarray(args[k]) for k in ("q", "k", "v", "rpe", "invalid", "w_rpe", "b_rpe", "g")]
    want = [np.asarray(x, dtype=np.float32) for x in jk._knarpe_bwd_pallas(*j, n_head, 4, interpret=True)]
    got = [t2n(x) for x in _plain(_torch(args), n_head)]
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)


@pytest.mark.parametrize("qt", range(N_BLOCKS))
def test_each_quarter_needs_only_its_own_slices_but_drpe(qt):
    """What the kernel's split rests on: the float32 plain backward on one quarter's slices alone (its 64 columns of
    q, g, k, v, W_k, W_v and the bias, two heads, all of rpe) gives that quarter's columns of dq, dk, dv, dW_rpe and
    db of the plain backward on the whole; its drpe is the quarter's share, and the four shares sum to the whole
    drpe; within the float32 tolerance (summation order of smaller products only)."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, 32, d, r, seed=7))
    whole = _plain(t, n_head)
    parts = [_plain(quarter_slices(t, i), n_head // N_BLOCKS) for i in range(N_BLOCKS)]
    dq = d // N_BLOCKS
    cols = slice(qt * dq, (qt + 1) * dq)
    both = lambda x: torch.cat([x[..., :d][..., cols], x[..., d:][..., cols]], -1)
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=F32_RTOL, atol=F32_ATOL)
    for i, name in enumerate(NAMES[:3]):
        close(parts[qt][i], whole[i][..., cols])
    close(parts[qt][4], both(whole[4]))
    close(parts[qt][5], both(whole[5]))
    close(sum(p[3] for p in parts), whole[3])


def test_heads_bwd_arithmetic_needs_the_lo_halves():
    """Without the lo halves of u, w, scale dl, attn and z' (bf16 operands alone, 8 significant bits) the emulation
    leaves phase 3's tolerance: the split is what keeps the kernel at float32 level."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, 32, d, r, seed=32))
    want = _plain(t, n_head)
    assert max(_excess(a, b) for a, b in zip(heads_bwd_emulation(t, n_head), want)) <= 0
    assert max(_excess(a, b) for a, b in zip(heads_bwd_emulation(t, n_head, lo=False), want)) > 0
