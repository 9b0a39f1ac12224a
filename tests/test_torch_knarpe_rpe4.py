"""PyTorch port: the arithmetic of bf16 B2 and B2/B3-bwd on the staged kernels at d_rpe = 4, on the CPU.

pose_rpe "xy_dir" feeds every KNARPE attention a 4-wide RPE (x, y, cos, sin). Its 8-byte rows are below the staged
kernels' 16-byte copies and one k step of the tensor cores, so `csrc/knarpe_staged.cuh` (B2, B3) and
`csrc/knarpe_bwd_staged.cuh` (B2/B3-bwd) stage them zero-padded to 16 columns and hold W_rpe's rows 4-15 as zeros:
X = D + 16 inputs per target. The kernels themselves run only on the card (chip_smoke.py phase 3 holds them against
their plain versions there); their routes, with the built library's answers faked, are tested in
tests/test_torch_knarpe_grad.py. Here a torch emulation of one block's arithmetic per
source: the padded inputs, float32 operands split into bf16 hi + lo (u, attn and y in the forward; u | w, scale dl,
attn and z' in the backward), the sums over X and over the targets in the kernels' 16-wide k steps (the forward's
logits and output in two chains, even and odd steps), the backward's pbuf rows over the D + 4 real inputs and the
weight gradients from them in bwd_chunks' chunks of sources, one rounding to bf16 at each output. It runs at the
flagship's widths (D=128, R=4, H=4) and the phase-4 config's (D=64, R=4, H=2), K in {3, 11, 89}, with an all-invalid
and a one-target source, and is held against:
  - `knarpe_cross_attention_reference` and its autograd backward in float32 on the same bf16-valued inputs, at
    chip_smoke.py phase 3's bf16 tolerance: 2^-8 of each value plus 1e-4 of each output's largest magnitude;
  - through that plain version, the JAX package's `knarpe_cross_attention` and `_knarpe_x_bwd_pallas` in interpret mode
    on the same numpy-seeded inputs, at 5e-5 absolute plus 1e-5 relative (summation order only);
  - the padding itself: the plain forward and backward on rpe and W_rpe zero-padded to 16 give the same bits as on the
    4-wide ones (the padded drpe and dW_rpe columns and rows exactly zero), and so does the emulation.
Dropping the lo halves of the split operands leaves the tolerance: the kernels carry them for float32-level results.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe

set_threads()
BF16_HALF_ULP, MAX_REL, F32_ATOL, F32_RTOL = 2.0 ** -8, 1e-4, 5e-5, 1e-5
R, R_STAGED, K_STEP = 4, 16, 16  # rpe columns in device memory, in a staged row; a tensor-core k step
WIDTHS = [(128, 4), (64, 2)]  # (d_model, n_head): the flagship's, the phase-4 config's
N_SRC = 6
OPERANDS = ("q", "tgt", "rpe", "invalid", "w_kv", "w_rpe", "b")
NAMES = ("dq", "dtgt", "drpe", "dw_kv", "dw_rpe", "db")


def _inputs(n_s, n_knn, d, seed):
    """B2 operands and the incoming gradient g at d_rpe = 4 (numpy, float32 values that bf16 holds exactly): source 0
    has no valid target, the last one a single valid target; weights scaled by 1/sqrt(fan-in), as chip_smoke.py's."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    inv = rng.uniform(size=(1, n_s, n_knn)) < 0.3
    inv[0, 0] = True
    inv[0, -1] = True
    inv[0, -1, n_knn // 2] = False
    args = dict(q=f(1, n_s, d), tgt=f(1, n_s, n_knn, d), rpe=f(1, n_s, n_knn, R), invalid=inv,
                w_kv=f(d, 2 * d, scale=d ** -0.5), w_rpe=f(R, 2 * d, scale=R ** -0.5), b=f(2 * d, scale=0.1),
                g=f(1, n_s, d))
    return {k: v if v.dtype == bool else v.astype(jnp.bfloat16).astype(np.float32) for k, v in args.items()}


def _torch(args):
    return {k: torch.from_numpy(v) for k, v in args.items()}


def _split(x, lo=True):
    """bf16 hi + lo of float32 values, each as float32 (hi + lo keeps 16 significant bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(x))


def _r16(x):
    return x.to(torch.bfloat16).float()


def _padded(t: dict, width: int) -> dict:
    """t with rpe zero-padded to `width` columns and W_rpe to `width` rows."""
    n_b, n_s, n_knn, r = t["rpe"].shape
    return {**t, "rpe": torch.cat([t["rpe"], torch.zeros(n_b, n_s, n_knn, width - r)], -1),
            "w_rpe": torch.cat([t["w_rpe"], torch.zeros(width - r, t["w_rpe"].shape[1])], 0)}


def _steps(width: int, step: int):
    """The k steps over `width` inputs: slices of `step`, the last one short where width is no multiple of it."""
    return [slice(i, min(i + step, width)) for i in range(0, width, step)]


def _over_x(xs, ys, eq: str, chains: int):
    """sum over the input columns of einsum(eq, xs[.., cols], ys[cols, ..]) in the kernels' 16-wide k steps of
    [tgt | rpe] (tgt's steps, then rpe's), in `chains` chains of alternate steps added at the end."""
    parts = [0.0] * chains
    for i, cols in enumerate(_steps(ys.shape[0], K_STEP)):
        parts[i % chains] = parts[i % chains] + torch.einsum(eq, xs[..., cols], ys[cols])
    return sum(parts[1:], parts[0])


def _over_targets(a, x):
    """sum_j a[s, c, j] x[s, j, i] in k steps of 16 targets, one chain."""
    out = 0.0
    for js in _steps(x.shape[1], K_STEP):
        out = out + torch.einsum("scj,sji->sci", a[..., js], x[:, js])
    return out


def _head_mask(d: int, n_head: int):
    """[D, H]: 1 where column d belongs to head h."""
    return (torch.arange(d)[:, None] // (d // n_head) == torch.arange(n_head)[None]).float()


def _softmax(logits, inv):
    m = torch.where(inv, -1e9, logits).amax(-1, keepdim=True)
    ex = torch.where(inv, 0.0, torch.exp(logits - m))
    den = ex.sum(-1, keepdim=True)
    return ex / torch.where(den <= 0, 1.0, den), den[..., 0] <= 0


def fwd_emulation(t: dict, n_head: int, width: int = R_STAGED, lo: bool = True):
    """bf16 B2 on the staged kernel, one source a block, rpe staged `width` columns wide (16: the kernel; 4: the same
    steps without the padding); lo=False drops the lo halves. -> out [B, S, D], float32 values of bf16."""
    t = _padded(t, width)
    n_b, n_s, n_knn, d = t["tgt"].shape
    scale = 1.0 / (d // n_head) ** 0.5
    x = torch.cat([t["tgt"], t["rpe"]], -1).reshape(n_b * n_s, n_knn, -1)  # [S, K, X]
    inv = t["invalid"].reshape(-1, n_knn)
    w, b = torch.cat([t["w_kv"], t["w_rpe"]], 0), t["b"]  # [X, 2D]
    q = t["q"].reshape(-1, d)
    hm = _head_mask(d, n_head)
    # u[i][h] = W_k[i, head h] . q_h over d in k steps of 16 (bf16 x bf16 products, exact in float32)
    qm = q[:, :, None] * hm  # [S, D, H]: Q, the head-masked q
    u = 0.0
    for ds in _steps(d, K_STEP):
        u = u + torch.einsum("id,sdh->sih", w[:, :d][:, ds], qm[:, ds])
    u_hi, u_lo = _split(u, lo)  # [S, X, H]
    c = torch.einsum("d,sdh->sh", b[:d], qm)
    # logits = x [U_hi | U_lo] + c: even and odd k steps in two chains, then the hi and lo columns added
    lgt = _over_x(x, u_hi.transpose(0, 1), "sji,ish->sjh", 2) + _over_x(x, u_lo.transpose(0, 1), "sji,ish->sjh", 2)
    attn, no_valid = _softmax(((lgt + c[:, None]) * scale).transpose(1, 2), inv[:, None])  # [S, H, K]
    a_hi, a_lo = _split(attn, lo)
    y = _over_targets(a_hi, x) + _over_targets(a_lo, x)  # [S, H, X]: rows h (hi) and H + h (lo) added
    y_hi, y_lo = _split(y, lo)
    # out = [Y_hi; Y_lo] W_v, the rows of head h(d) kept, in two chains, + b_v sum_j attn
    wv = w[:, d:]
    o = (_over_x(y_hi, wv, "shi,id->shd", 2) + _over_x(y_lo, wv, "shi,id->shd", 2))
    o = (o * hm.T[None]).sum(1) + b[d:] * (attn.sum(-1) @ hm.T)
    o = torch.where((no_valid.float() @ hm.T) > 0, 0.0, o)
    return _r16(o).reshape(n_b, n_s, d)


def bwd_emulation(t: dict, n_head: int, width: int = R_STAGED, lo: bool = True):
    """bf16 B2-bwd on the staged kernel and the weight-gradient passes, rpe staged `width` columns wide; lo=False drops
    the lo halves. -> (dq, dtgt, drpe, dw_kv, dw_rpe, db) as float32 values of bf16."""
    r = t["rpe"].shape[-1]
    t = _padded(t, width)
    n_b, n_s, n_knn, d = t["tgt"].shape
    n_src, dh = n_b * n_s, d // n_head
    scale = 1.0 / dh ** 0.5
    x = torch.cat([t["tgt"], t["rpe"]], -1).reshape(n_src, n_knn, -1)
    inv = t["invalid"].reshape(-1, n_knn)
    w, b = torch.cat([t["w_kv"], t["w_rpe"]], 0), t["b"]
    q, g = t["q"].reshape(-1, d), t["g"].reshape(-1, d)
    hm = _head_mask(d, n_head)
    qm, gm = q[:, :, None] * hm, g[:, :, None] * hm
    # 1. [u | w] = W_k Q | W_v G over d in k steps, split hi / lo; the bias terms
    u, wg = 0.0, 0.0
    for ds in _steps(d, K_STEP):
        u = u + torch.einsum("id,sdh->sih", w[:, :d][:, ds], qm[:, ds])
        wg = wg + torch.einsum("id,sdh->sih", w[:, d:][:, ds], gm[:, ds])
    uw = torch.cat([u, wg], -1)  # [S, X, 2H]
    uw_hi, uw_lo = _split(uw, lo)
    cst = torch.cat([torch.einsum("d,sdh->sh", b[:d], qm), torch.einsum("d,sdh->sh", b[d:], gm)], -1)
    # 2. [logits | dattn] = x [UW_hi | UW_lo], one chain each, hi + lo
    v = _over_x(x, uw_hi.transpose(0, 1), "sji,isc->sjc", 1) + _over_x(x, uw_lo.transpose(0, 1), "sji,isc->sjc", 1)
    v = (v + cst[:, None]).transpose(1, 2)  # [S, 2H, K]
    logits, dattn = v[:, :n_head] * scale, v[:, n_head:]
    # 3. softmax, scale dl = scale attn (dattn - sum attn dattn); P = [scale DL | A] hi / lo
    attn, _ = _softmax(logits, inv[:, None])
    sdl = scale * (attn * (dattn - (attn * dattn).sum(-1, keepdim=True)))
    p = torch.cat([sdl, attn], 1)  # [S, 2H, K]
    p_hi, p_lo = _split(p, lo)
    # 4. [z'; y] = P x over the targets, rows hi + lo -> pbuf (the D + r real inputs, then the bias's sums)
    zy = _over_targets(p_hi, x) + _over_targets(p_lo, x)  # [S, 2H, X]
    pbuf = torch.cat([zy[..., :d + r], p.sum(-1, keepdim=True)], -1)  # [S, 2H, D + r + 1]
    z_hi, z_lo = _split(zy[:, :n_head], lo)
    # dx = (P_hi + P_lo) UW_hi + (P_hi + P_lo) UW_lo
    dx = (torch.einsum("scj,sic->sji", p_hi, uw_hi) + torch.einsum("scj,sic->sji", p_lo, uw_hi)
          + (torch.einsum("scj,sic->sji", p_hi, uw_lo) + torch.einsum("scj,sic->sji", p_lo, uw_lo)))
    # dq = [Z_hi; Z_lo] W_k in two chains, the rows of head h(d) kept, + b_k sum scale dl
    wk = w[:, :d]
    dq = _over_x(z_hi, wk, "shi,id->shd", 2) + _over_x(z_lo, wk, "shi,id->shd", 2)
    dq = (dq * hm.T[None]).sum(1) + b[:d] * (sdl.sum(-1) @ hm.T)
    # the weight gradients: P^T [q | g] per head over chunks of sources, the chunks added in order
    n_chunks = knarpe.bwd_chunks(n_src, d + r + 1, d, n_head)
    per = -(-n_src // n_chunks)
    qg = torch.stack([q.reshape(n_src, n_head, dh), g.reshape(n_src, n_head, dh)], 1)  # [S, 2, H, dh]
    rows = pbuf.reshape(n_src, 2, n_head, -1)
    dw = sum(torch.einsum("skhi,skhd->ikhd", rows[c:c + per], qg[c:c + per]) for c in range(0, n_src, per))
    dw = dw.reshape(d + r + 1, 2 * d)
    return (_r16(dq).reshape(n_b, n_s, d), _r16(dx[..., :d]).reshape(n_b, n_s, n_knn, d),
            _r16(dx[..., d:d + r]).reshape(n_b, n_s, n_knn, r), _r16(dw[:d]), _r16(dw[d:d + r]), _r16(dw[-1]))


def _excess(got, ref):
    """How far |got - ref| exceeds 2^-8 |ref| + 1e-4 max |ref|, at its worst (<= 0: within)."""
    return float(((got - ref).abs() - (BF16_HALF_ULP * ref.abs() + MAX_REL * float(ref.abs().max()))).max())


def _plain_fwd(t: dict, n_head: int):
    return knarpe.knarpe_cross_attention_reference(*[t[k] for k in OPERANDS], n_head)


def _plain_bwd(t: dict, n_head: int):
    return knarpe.knarpe_cross_attention_bwd_reference(*[t[k] for k in OPERANDS], t["g"], n_head)


CASES = [(d, h, k) for d, h in WIDTHS for k in (3, 11, 89)]


@pytest.mark.parametrize("d,n_head,n_knn", CASES)
def test_rpe4_forward_arithmetic_matches_the_plain_version(d, n_head, n_knn):
    """The emulated staged forward at d_rpe = 4 within the bf16 tolerance of the float32 plain version on the same
    bf16-valued inputs; the all-invalid source exactly zero."""
    t = _torch(_inputs(N_SRC, n_knn, d, seed=400 + n_knn + d))
    got, want = fwd_emulation(t, n_head), _plain_fwd(t, n_head)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _excess(got, want) <= 0
    assert torch.all(got[0, 0] == 0) and torch.all(want[0, 0] == 0)


@pytest.mark.parametrize("d,n_head,n_knn", CASES)
def test_rpe4_backward_arithmetic_matches_the_plain_backward(d, n_head, n_knn):
    """The emulated staged backward and weight-gradient passes at d_rpe = 4 within the bf16 tolerance of the float32
    plain backward on the same bf16-valued inputs, every gradient; drpe and dW_rpe 4 wide."""
    t = _torch(_inputs(N_SRC, n_knn, d, seed=500 + n_knn + d))
    got, want = bwd_emulation(t, n_head), _plain_bwd(t, n_head)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _excess(a, b) <= 0, name


@pytest.mark.parametrize("d,n_head", WIDTHS)
def test_rpe4_edge_sources(d, n_head):
    """The all-invalid source gets exactly zero out, dq, dtgt and drpe in the emulations and the plain versions; the
    one-target source (attn 1 at its target, so dl = 0) exactly zero dq in the emulation and the plain backward's
    non-zero dtgt and drpe (attn w) within the bf16 tolerance."""
    t = _torch(_inputs(N_SRC, 89, d, seed=600 + d))
    out, grads, want = fwd_emulation(t, n_head), bwd_emulation(t, n_head), _plain_bwd(t, n_head)
    assert torch.all(out[0, 0] == 0)
    assert all(torch.all(x[0, 0] == 0) for x in grads[:3]) and all(torch.all(x[0, 0] == 0) for x in want[:3])
    assert torch.all(grads[0][0, -1] == 0) and float(want[0][0, -1].abs().max()) < F32_ATOL
    for name, a, b in zip(NAMES[1:3], grads[1:3], want[1:3]):
        assert _excess(a[0, -1], b[0, -1]) <= 0 and torch.any(b[0, -1] != 0), name


@pytest.mark.parametrize("d,n_head,n_knn", CASES)
def test_plain_version_matches_the_tpu_kernels_at_rpe4(d, n_head, n_knn):
    """The plain forward and backward against the JAX package's `knarpe_cross_attention` and `_knarpe_x_bwd_pallas`
    in interpret mode on the same inputs at d_rpe = 4 (source tiles of 4 over 6 sources: no multiple of the tile), to
    5e-5 absolute plus 1e-5 relative."""
    args = _inputs(N_SRC, n_knn, d, seed=400 + n_knn + d)
    j = [jnp.asarray(args[k]) for k in OPERANDS]
    t = _torch(args)
    want_out = np.asarray(jk.knarpe_cross_attention(*j, n_head, 4, True), dtype=np.float32)
    np.testing.assert_allclose(t2n(_plain_fwd(t, n_head)), want_out, rtol=F32_RTOL, atol=F32_ATOL)
    want = [np.asarray(x, dtype=np.float32)
            for x in jk._knarpe_x_bwd_pallas(*j, jnp.asarray(args["g"]), n_head, 4, interpret=True)]
    for name, a, b in zip(NAMES, [t2n(x) for x in _plain_bwd(t, n_head)], want):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)


@pytest.mark.parametrize("d,n_head,n_knn", [(128, 4, 89), (64, 2, 11)])
def test_rpe4_padding_changes_no_bit(d, n_head, n_knn):
    """rpe zero-padded to 16 columns and W_rpe to 16 rows: the plain forward gives the same bits, the plain backward
    the same bits in every gradient, the padded drpe columns and dW_rpe rows exactly zero; the emulations on 16 staged
    columns give the bits of the same steps on the 4 alone."""
    t = _torch(_inputs(N_SRC, n_knn, d, seed=700 + n_knn))
    p = _padded(t, R_STAGED)
    assert torch.equal(_plain_fwd(p, n_head), _plain_fwd(t, n_head))
    whole, pad = _plain_bwd(t, n_head), _plain_bwd(p, n_head)
    for name, a, b in zip(NAMES, whole, pad):
        if name == "drpe":
            assert torch.equal(b[..., :R], a) and torch.all(b[..., R:] == 0), name
        elif name == "dw_rpe":
            assert torch.equal(b[:R], a) and torch.all(b[R:] == 0), name
        else:
            assert torch.equal(a, b), name
    assert torch.equal(fwd_emulation(t, n_head), fwd_emulation(t, n_head, width=R))
    for name, a, b in zip(NAMES, bwd_emulation(t, n_head), bwd_emulation(t, n_head, width=R)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d,n_head", WIDTHS)
def test_rpe4_arithmetic_needs_the_lo_halves(d, n_head):
    """Without the lo halves of the split operands (bf16 alone, 8 significant bits) the emulations leave the
    tolerance: the split is what keeps the kernels at float32 level."""
    t = _torch(_inputs(N_SRC, 89, d, seed=800 + d))
    want_out, want = _plain_fwd(t, n_head), _plain_bwd(t, n_head)
    assert _excess(fwd_emulation(t, n_head), want_out) <= 0
    assert max(_excess(a, b) for a, b in zip(bwd_emulation(t, n_head), want)) <= 0
    assert _excess(fwd_emulation(t, n_head, lo=False), want_out) > 0
    assert max(_excess(a, b) for a, b in zip(bwd_emulation(t, n_head, lo=False), want)) > 0
