"""PyTorch port: the arithmetic of bf16 B2/B3-bwd's heads kernel (`csrc/knarpe_bwd_heads.cuh`), on the CPU.

The kernel itself runs only on the card (tests/test_torch_knarpe_cuda.py and chip_smoke.py phase 3 hold it against
autograd of its plain version there); its route, with the built library's answers faked, is tested in
tests/test_torch_knarpe_grad.py. Here a torch emulation of one block's backward arithmetic (its head: the 32 columns
of q, g and dq and of each half ([W_k | W_v]) of W_kv, W_rpe and the bias that belong to it, and all of tgt and rpe;
u, w, scale dl, attn and z' split into bf16 hi + lo operands; the logits' four quarters of X summed in order; its rows
of pbuf and its dx factors F = [scale dl | attn], G = [u | w]), the eight blocks side by side, dtgt | drpe formed from
the sixteen factor columns in block order and the weight gradients from pbuf, one rounding to bf16 at each output, at
D=R=256, H=8, K in {5, 24, 89}, with an all-invalid and a one-target source, is held against
`knarpe_cross_attention_bwd_reference` in float32 on the same bf16-valued inputs at chip_smoke.py phase 3's bf16
tolerance: 2^-8 of each value plus 1e-4 of each gradient's largest magnitude. The same inputs also go through the JAX
package's backward kernel (`pallas_knarpe._knarpe_x_bwd_pallas`) in interpret mode, to which the plain backward agrees
within test_torch_knarpe_grad.py's float32 tolerance (5e-5 absolute plus 1e-5 relative). The plain backward on one
head's slices alone gives that head's columns of dq and of the weight gradients, and its dtgt and drpe are that head's
share: the eight shares sum to the whole, within the float32 tolerance. Dropping the lo halves of the split operands
exceeds the bf16 tolerance, so the emulation shows why the kernel carries them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe
from trafficbotsv15_tpu_torch.ops.attention import knn_attention

set_threads()
BF16_HALF_ULP, BWD_REL, F32_ATOL, F32_RTOL = 2.0 ** -8, 1e-4, 5e-5, 1e-5
SCALED = (256, 256, 8)  # the scaled preset's d_model, d_rpe, n_head
N_BLOCKS = 8  # blocks per source, one on each head
N_PARTS = 4  # the logits step's quarters of X
N_SRC = 6
NAMES = ("dq", "dtgt", "drpe", "dw_kv", "dw_rpe", "db")
OPERANDS = ("q", "tgt", "rpe", "invalid", "w_kv", "w_rpe", "b")


def _inputs(n_s, n_knn, d, r, seed):
    """B2 operands and the incoming gradient g (numpy, float32 values that bf16 holds exactly): source 0 has no valid
    target, the last one a single valid target; weights scaled by 1/sqrt(fan-in), as chip_smoke.py's."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    inv = rng.uniform(size=(1, n_s, n_knn)) < 0.3
    inv[0, 0] = True
    inv[0, -1] = True
    inv[0, -1, n_knn // 2] = False
    args = dict(q=f(1, n_s, d), tgt=f(1, n_s, n_knn, d), rpe=f(1, n_s, n_knn, r), invalid=inv,
                w_kv=f(d, 2 * d, scale=d ** -0.5), w_rpe=f(r, 2 * d, scale=r ** -0.5), b=f(2 * d, scale=0.1),
                g=f(1, n_s, d))
    return {k: v if v.dtype == bool else v.astype(jnp.bfloat16).astype(np.float32) for k, v in args.items()}


def _torch(args):
    return {k: torch.from_numpy(v) for k, v in args.items()}


def _split(x, lo=True):
    """bf16 hi + lo of float32 values, each as float32 (hi + lo keeps 16 significant bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(x))


def head_slices(t: dict, h: int) -> dict:
    """Block h's operands: the 32 columns of q and g of head h, the same columns of each half ([W_k | W_v]) of W_kv,
    W_rpe and the bias; tgt, rpe and the mask whole."""
    d = t["q"].shape[-1]
    cols = slice(h * d // N_BLOCKS, (h + 1) * d // N_BLOCKS)
    halves = lambda x: torch.cat([x[..., :d][..., cols], x[..., d:][..., cols]], -1)
    return dict(q=t["q"][..., cols], tgt=t["tgt"], rpe=t["rpe"], invalid=t["invalid"], w_kv=halves(t["w_kv"]),
                w_rpe=halves(t["w_rpe"]), b=halves(t["b"]), g=t["g"][..., cols])


def block_emulation(t: dict, scale: float, lo: bool = True) -> dict:
    """One block's arithmetic on its head (`head_slices`), in float32 from bf16 operands; lo=False drops the lo halves
    of the split operands. -> dq [S, DH] before the rounding to bf16, its pbuf rows zk [S, X + 1] (k half: z', scale
    sum dl) and yv (v half: y, sum attn), F [S, K, 2] and G [S, 2, X]."""
    dh = t["q"].shape[-1]
    q, g = t["q"].reshape(-1, dh), t["g"].reshape(-1, dh)
    n_knn = t["tgt"].shape[2]
    x = torch.cat([t["tgt"], t["rpe"]], -1).reshape(q.shape[0], n_knn, -1)  # [S, K, X]
    inv = t["invalid"].reshape(-1, n_knn)
    w, b = torch.cat([t["w_kv"], t["w_rpe"]], 0), t["b"]  # [X, 2 DH]: the head's W_k, then W_v columns
    wk, wv = w[:, :dh], w[:, dh:]
    u, ww = q @ wk.T, g @ wv.T  # [u | w] = W_k Q + W_v G [S, X]
    u_hi, u_lo = _split(u, lo)
    w_hi, w_lo = _split(ww, lo)
    c = (b[:dh] * q).sum(-1)  # b_k,h . q_h [S]
    e = (b[dh:] * g).sum(-1)  # b_v,h . g_h
    quarter = x.shape[-1] // N_PARTS
    lgt, dattn = 0.0, 0.0
    for part in range(N_PARTS):  # the quarters of X, each its hi and lo columns summed, then in order
        sl = slice(part * quarter, (part + 1) * quarter)
        xs = x[:, :, sl]
        lgt = lgt + (torch.einsum("sji,si->sj", xs, u_hi[:, sl]) + torch.einsum("sji,si->sj", xs, u_lo[:, sl]))
        dattn = dattn + (torch.einsum("sji,si->sj", xs, w_hi[:, sl]) + torch.einsum("sji,si->sj", xs, w_lo[:, sl]))
    logits = (lgt + c[:, None]) * scale  # [S, K]
    dattn = dattn + e[:, None]
    m = torch.where(inv, -1e9, logits).amax(-1, keepdim=True)
    ex = torch.where(inv, 0.0, torch.exp(logits - m))
    den = ex.sum(-1, keepdim=True)
    attn = ex / torch.where(den <= 0, 1.0, den)
    sdl = scale * (attn * (dattn - (attn * dattn).sum(-1, keepdim=True)))  # scale dl [S, K]
    s_hi, s_lo = _split(sdl, lo)
    a_hi, a_lo = _split(attn, lo)
    z = torch.einsum("sj,sji->si", s_hi, x) + torch.einsum("sj,sji->si", s_lo, x)  # z' = sum_j scale dl_j x_j
    y = torch.einsum("sj,sji->si", a_hi, x) + torch.einsum("sj,sji->si", a_lo, x)
    z_hi, z_lo = _split(z, lo)
    dq = (z_hi @ wk + z_lo @ wk) + b[:dh] * sdl.sum(-1, keepdim=True)  # W_k^T [Z_hi | Z_lo] + b_k sum scale dl
    return dict(dq=dq, zk=torch.cat([z, sdl.sum(-1, keepdim=True)], -1), yv=torch.cat([y, attn.sum(-1, keepdim=True)], -1),
                F=torch.stack([sdl, attn], -1), G=torch.stack([u, ww], 1))


def heads_bwd_emulation(t: dict, n_head: int, lo: bool = True):
    """The eight blocks of a source side by side, each from its own head's slices alone; dx = F G over the sixteen
    factor columns in block order (dtgt its first D columns, drpe the rest), the weight gradients from pbuf's rows
    (P^T [q | g], the bias from row X), each rounded once to bf16. -> (dq, dtgt, drpe, dw_kv, dw_rpe, db) as float32
    values of bf16."""
    n_b, n_s, n_knn, d = t["tgt"].shape
    scale = 1.0 / (d // n_head) ** 0.5
    blocks = [block_emulation(head_slices(t, h), scale, lo) for h in range(N_BLOCKS)]
    f_cols = torch.cat([blk["F"] for blk in blocks], -1)  # [S, K, 16]
    g_rows = torch.cat([blk["G"] for blk in blocks], 1)  # [S, 16, X]
    dx = torch.zeros(f_cols.shape[0], n_knn, g_rows.shape[-1])
    for col in range(f_cols.shape[-1]):  # the dx pass's order
        dx = dx + f_cols[:, :, col, None] * g_rows[:, None, col, :]
    zk = torch.stack([blk["zk"] for blk in blocks], 1)  # pbuf's k half [S, H, X + 1]
    yv = torch.stack([blk["yv"] for blk in blocks], 1)  # and its v half
    dh = d // n_head
    q, g = t["q"].reshape(-1, n_head, dh), t["g"].reshape(-1, n_head, dh)
    dw_k = torch.einsum("shi,shd->ihd", zk, q).reshape(-1, d)  # [X + 1, D]: row X is the bias
    dw_v = torch.einsum("shi,shd->ihd", yv, g).reshape(-1, d)
    dw = torch.cat([dw_k, dw_v], -1)
    r16 = lambda v: v.to(torch.bfloat16).float()
    dq = torch.cat([blk["dq"] for blk in blocks], -1)
    return (r16(dq).reshape(n_b, n_s, d), r16(dx[..., :d]).reshape(n_b, n_s, n_knn, d),
            r16(dx[..., d:]).reshape(n_b, n_s, n_knn, -1), r16(dw[:d]), r16(dw[d:-1]), r16(dw[-1]))


def _excess(got, ref):
    """How far |got - ref| exceeds phase 3's bf16 tolerance, 2^-8 |ref| + 1e-4 max |ref|, at its worst (<= 0: within)."""
    return float(((got - ref).abs() - (BF16_HALF_ULP * ref.abs() + BWD_REL * float(ref.abs().max()))).max())


def _plain(t: dict, n_head: int):
    return knarpe.knarpe_cross_attention_bwd_reference(*[t[k] for k in OPERANDS], t["g"], n_head)


def _one_head(q, tgt, rpe, invalid, w_kv, w_rpe, b):
    """Plain B2 of one head on its slices (`head_slices`): the projection to its [k | v] columns from all of tgt and
    rpe, then `knn_attention` with that head (d_head = q's width, so the scale is the whole model's)."""
    n_b, n_s, n_knn, d = tgt.shape
    dh = q.shape[-1]
    kv = tgt.reshape(-1, d) @ w_kv + rpe.reshape(-1, rpe.shape[-1]) @ w_rpe + b
    k, v = (x.reshape(n_b, n_s, n_knn, 1, dh) for x in kv.reshape(n_b, n_s, n_knn, 2 * dh).chunk(2, -1))
    return knn_attention(q.reshape(n_b, n_s, 1, dh), k, v, invalid).reshape(n_b, n_s, dh)


def _plain_head(t: dict):
    """Autograd of `_one_head`: (dq, dtgt, drpe, dw_kv, dw_rpe, db) of one head's slices."""
    dq, dtgt, drpe, _, dwk, dwr, db = knarpe._plain_grads(_one_head, [t[k] for k in OPERANDS], t["g"])
    return dq, dtgt, drpe, dwk, dwr, db


@pytest.mark.parametrize("n_knn", [5, 24, 89])
def test_heads_x_bwd_arithmetic_matches_the_plain_backward(n_knn):
    """The emulated kernel at D=R=256, H=8 within phase 3's bf16 tolerance of the float32 plain backward on the same
    bf16-valued inputs, every gradient."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, n_knn, d, r, seed=200 + n_knn))
    got, want = heads_bwd_emulation(t, n_head), _plain(t, n_head)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _excess(a, b) <= 0, name


@pytest.mark.parametrize("n_knn", [1, 89])
def test_heads_x_bwd_edge_sources(n_knn):
    """The all-invalid source gets exactly zero dq, dtgt and drpe in the emulation and in the plain backward; the
    one-target source (attn 1 at its target, so dl = 0) exactly zero dq and the plain backward's non-zero dtgt and
    drpe (attn w) at the bf16 tolerance."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, n_knn, d, r, seed=300 + n_knn))
    got, want = heads_bwd_emulation(t, n_head), _plain(t, n_head)
    assert all(torch.all(x[0, 0] == 0) for x in got[:3]) and all(torch.all(x[0, 0] == 0) for x in want[:3])
    assert torch.all(got[0][0, -1] == 0) and float(want[0][0, -1].abs().max()) < F32_ATOL
    for name, a, b in zip(NAMES[1:3], got[1:3], want[1:3]):
        assert _excess(a[0, -1], b[0, -1]) <= 0 and torch.any(b[0, -1] != 0), name


@pytest.mark.parametrize("n_knn", [5, 24, 89])
def test_plain_backward_matches_the_tpu_kernel_at_the_scaled_widths(n_knn):
    """The plain backward against the JAX package's `_knarpe_x_bwd_pallas` in interpret mode on the same inputs at
    D=R=256, H=8 (source tiles of 4 over 6 sources: no multiple of the tile), to test_torch_knarpe_grad.py's float32
    tolerance."""
    d, r, n_head = SCALED
    args = _inputs(N_SRC, n_knn, d, r, seed=200 + n_knn)
    j = [jnp.asarray(args[k]) for k in (*OPERANDS, "g")]
    want = [np.asarray(x, dtype=np.float32) for x in jk._knarpe_x_bwd_pallas(*j, n_head, 4, interpret=True)]
    got = [t2n(x) for x in _plain(_torch(args), n_head)]
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)


@pytest.mark.parametrize("h", range(N_BLOCKS))
def test_each_head_needs_only_its_own_slices_but_dx(h):
    """What the kernel's split rests on: the float32 plain backward on one head's slices alone (its 32 columns of q, g,
    W_k, W_v and the bias, all of tgt and rpe) gives that head's columns of dq, dW_kv, dW_rpe and db of the plain
    backward on the whole; its dtgt and drpe are the head's share, and the eight shares sum to the whole; within the
    float32 tolerance (summation order of smaller products only)."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, 24, d, r, seed=9))
    whole = _plain(t, n_head)
    parts = [_plain_head(head_slices(t, i)) for i in range(N_BLOCKS)]
    dh = d // N_BLOCKS
    cols = slice(h * dh, (h + 1) * dh)
    both = lambda x: torch.cat([x[..., :d][..., cols], x[..., d:][..., cols]], -1)
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=F32_RTOL, atol=F32_ATOL)
    close(parts[h][0], whole[0][..., cols])
    for i in (3, 4, 5):
        close(parts[h][i], both(whole[i]))
    for i in (1, 2):
        close(sum(p[i] for p in parts), whole[i])


def test_heads_x_bwd_arithmetic_needs_the_lo_halves():
    """Without the lo halves of u, w, scale dl, attn and z' (bf16 operands alone, 8 significant bits) the emulation
    leaves phase 3's tolerance: the split is what keeps the kernel at float32 level."""
    d, r, n_head = SCALED
    t = _torch(_inputs(N_SRC, 89, d, r, seed=89))
    want = _plain(t, n_head)
    assert max(_excess(a, b) for a, b in zip(heads_bwd_emulation(t, n_head), want)) <= 0
    assert max(_excess(a, b) for a, b in zip(heads_bwd_emulation(t, n_head, lo=False), want)) > 0
