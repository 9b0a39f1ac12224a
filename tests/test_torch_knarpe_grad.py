"""PyTorch port: the KNARPE attention backwards' plain versions against the TPU backward kernels.

The port's plain backwards, `knarpe_attention_bwd_reference` (B4-bwd) and
`knarpe_cross_attention_bwd_reference` (B2-bwd, also B3's), are autograd
through the plain forwards. They are held against
`trafficbotsv15_tpu/ops/pallas_knarpe.py`'s `_knarpe_bwd_pallas` and
`_knarpe_x_bwd_pallas` in interpret mode, as `tests/test_pallas_knarpe.py`
runs them, at its shapes (B=2, S=8, K=4, H=2, d_head=8, R=16) and with
source counts that are no multiple of the Pallas tile (S=10 and 9 with tiles
of 4 and 8), plus a larger K=89 case; every case has a source whose targets
are all invalid (its gradients are zero) and a source with one valid target.

Tolerances (gradients of size up to ~30):
  - float32: 5e-5 absolute plus 1e-5 relative, summation order only (the
    Pallas kernel sums per head through segment matmuls and over the tile's
    sources in another order);
  - bfloat16, the interpret-mode kernel computing in float32 inside against
    a plain version that rounds every op to bf16: 2^-4 of the largest
    gradient of each output.
The wrappers' autograd on the CPU takes these plain backwards and counts no
launch; B3's CPU backward is B2's, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import set_threads, t2n
from trafficbotsv15_tpu.ops import pallas_knarpe as jk
from trafficbotsv15_tpu_torch.ops import knarpe

set_threads()
N_HEAD, D_HEAD, R = 2, 8, 16
D = N_HEAD * D_HEAD
F32_ATOL, F32_RTOL, BF16_REL = 5e-5, 1e-5, 2.0 ** -4
# (n_b, n_s, K, s_tile): test_pallas_knarpe.py's shapes, non-divisible tiles, a wide K
SHAPES = [(2, 8, 4, 4), (1, 10, 4, 4), (1, 9, 4, 8), (2, 10, 4, 4), (2, 33, 89, 8)]
ATTN_NAMES = ("dq", "dk", "dv", "drpe", "dw_rpe", "db_rpe")
CROSS_NAMES = ("dq", "dtgt", "drpe", "dw_kv", "dw_rpe", "db")


def _inputs(n_b, n_s, n_knn, seed, cross):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    inv = rng.uniform(size=(n_b, n_s, n_knn)) < 0.3
    inv[0, 1] = True  # a source with no valid target
    inv[-1, 0, :-1] = True  # a source with one valid target
    inv[-1, 0, -1] = False
    g = f(n_b, n_s, D)
    if cross:
        return dict(q=f(n_b, n_s, D), tgt=f(n_b, n_s, n_knn, D), rpe=f(n_b, n_s, n_knn, R), invalid=inv,
                    w_kv=0.3 * f(D, 2 * D), w_rpe=0.3 * f(R, 2 * D), b=0.1 * f(2 * D)), g
    return dict(q=f(n_b, n_s, D), k=f(n_b, n_s, n_knn, D), v=f(n_b, n_s, n_knn, D), rpe=f(n_b, n_s, n_knn, R),
                invalid=inv, w_rpe=0.3 * f(R, 2 * D), b_rpe=0.1 * f(2 * D)), g


def _both(args, g, jdt, tdt):
    j = [jnp.asarray(v) if v.dtype == bool else jnp.asarray(v).astype(jdt) for v in args.values()]
    t = [torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(tdt) for v in args.values()]
    return j, jnp.asarray(g).astype(jdt), t, torch.from_numpy(g).to(tdt)


def _pallas_grads(cross, j, jg, s_tile):
    fn = jk._knarpe_x_bwd_pallas if cross else jk._knarpe_bwd_pallas
    return [np.asarray(x, dtype=np.float32) for x in fn(*j, jg, N_HEAD, s_tile, interpret=True)]


def _plain_grads(cross, t, tg):
    fn = knarpe.knarpe_cross_attention_bwd_reference if cross else knarpe.knarpe_attention_bwd_reference
    return [t2n(x) for x in fn(*t, tg, N_HEAD)]


@pytest.mark.parametrize("cross", [False, True], ids=["B4", "B2"])
@pytest.mark.parametrize("n_b,n_s,n_knn,s_tile", SHAPES)
def test_plain_backward_matches_tpu_kernel_f32(cross, n_b, n_s, n_knn, s_tile):
    args, g = _inputs(n_b, n_s, n_knn, seed=n_s * 100 + n_knn + n_b, cross=cross)
    j, jg, t, tg = _both(args, g, jnp.float32, torch.float32)
    want = _pallas_grads(cross, j, jg, s_tile)
    got = _plain_grads(cross, t, tg)
    for name, a, b in zip(CROSS_NAMES if cross else ATTN_NAMES, got, want):
        assert a.shape == b.reshape(a.shape).shape, name
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=F32_RTOL, atol=F32_ATOL, err_msg=name)
    np.testing.assert_array_equal(got[0][0, 1], 0.0)  # the all-invalid source's dq
    np.testing.assert_array_equal(got[1][0, 1], 0.0)  # and its dk / dtgt


@pytest.mark.parametrize("cross", [False, True], ids=["B4", "B2"])
def test_plain_backward_matches_tpu_kernel_bf16(cross):
    args, g = _inputs(2, 10, 5, seed=7, cross=cross)
    j, jg, t, tg = _both(args, g, jnp.bfloat16, torch.bfloat16)
    want = _pallas_grads(cross, j, jg, 4)
    got = _plain_grads(cross, t, tg)
    for name, a, b in zip(CROSS_NAMES if cross else ATTN_NAMES, got, want):
        b = b.reshape(a.shape)
        assert np.abs(a - b).max() <= BF16_REL * np.abs(b).max(), name


@pytest.mark.parametrize("name", ["knarpe_attention", "knarpe_cross_attention", "knarpe_cross_attention_v3"])
def test_cpu_wrapper_gradients_are_the_plain_backward(name):
    """Autograd through the CPU wrapper gives the plain backward (B2's for B3) and counts no launch."""
    cross = name != "knarpe_attention"
    args, g = _inputs(2, 8, 5, seed=11, cross=cross)
    _, _, t, tg = _both(args, g, jnp.float32, torch.float32)
    leaves = [x.requires_grad_(x.is_floating_point()) for x in t]
    before = dict(knarpe.LAUNCHES)
    out = getattr(knarpe, name)(*leaves, N_HEAD)
    assert out.grad_fn is not None
    out.backward(tg)
    assert knarpe.LAUNCHES == before
    want = _plain_grads(cross, [x.detach() for x in t], tg)
    got = [t2n(x.grad) for x in leaves if x.requires_grad]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bwd_chunks_fixed_by_shape():
    """The reduction's chunking depends on the shapes only (so its sum order is fixed)."""
    assert knarpe.bwd_chunks(8192, 257, 128, 4) == knarpe.bwd_chunks(8192, 257, 128, 4) == 13
    assert knarpe.bwd_chunks(5, 33, 16, 2) == 1
    assert all(knarpe.bwd_chunks(n, 129, 128, 4) >= 1 for n in (1, 63, 64, 4096))


def _fake_bwd_route(monkeypatch, codes):
    """Fake the built library's answer (`bwd_staged_refusal`); -> the calls, in order."""
    asked = []

    def answer(n_knn, d_model, d_rpe, n_head, device_index):
        asked.append((n_knn, d_model, d_rpe, n_head, device_index))
        return codes[0]

    monkeypatch.setattr(knarpe, "bwd_staged_refusal", answer)
    return asked


def test_bwd_route_sends_bf16_b2_to_the_staged_kernel(monkeypatch):
    """bf16 B2-bwd (B3's backward too) takes the staged kernel where the library's answer is 0, asked
    from the shape alone."""
    asked = _fake_bwd_route(monkeypatch, [0])
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 89, 128, 128, 4, 0) == "staged"
    assert asked == [(89, 128, 128, 4, 0)]


@pytest.mark.parametrize("code", sorted(knarpe.BWD_STAGED_REFUSALS))
def test_bwd_route_sends_each_refusal_to_the_general_kernel(code, monkeypatch):
    """Every refusal code of the staged backward sends bf16 B2-bwd to the general kernel; float32 B2-bwd
    and B4-bwd take the general kernel without asking the library."""
    asked = _fake_bwd_route(monkeypatch, [code])
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 24, 128, 128, 4, 0) == "general"
    assert asked == [(24, 128, 128, 4, 0)]
    asked.clear()
    assert knarpe.bwd_route("knarpe_cross_attention", torch.float32, 24, 128, 128, 4, 0) == "general"
    assert knarpe.bwd_route("knarpe_attention", torch.float32, 24, 128, 128, 4, 0) == "general"
    assert asked == []


def test_bwd_refusals_name_each_code():
    """One text per refusal code of `staged_bwd::refusal` (1-4) and the plan's no-fit (5), each its own."""
    texts = knarpe.BWD_STAGED_REFUSALS
    assert sorted(texts) == [1, 2, 3, 4, 5]
    assert len(set(texts.values())) == len(texts) and all(texts.values())
    assert "n_head" in texts[3] and "shared memory" in texts[4]


def _bf16_bwd_operands(misalign):
    args, g = _inputs(2, 3, 5, seed=4, cross=True)
    t = {k: torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(torch.bfloat16) for k, v in args.items()}
    if misalign:  # the same values one element into a buffer: contiguous, 2 bytes off a 16-byte boundary
        buf = torch.zeros(t["rpe"].numel() + 1, dtype=torch.bfloat16)
        buf[1:] = t["rpe"].reshape(-1)
        t["rpe"] = buf[1:].view(t["rpe"].shape)
    return t, torch.from_numpy(g).to(torch.bfloat16)


@pytest.mark.parametrize("route_code", [0, 3])
def test_launch_bwd_raises_for_misaligned_bf16_operands_on_the_staged_route(route_code, monkeypatch):
    """The staged backward copies 16-byte chunks: a bf16 operand 2 bytes off a 16-byte boundary at a shape
    it takes raises before any launch (the route follows from the shape, not from the addresses). On the
    general route the check does not apply, and the launch itself needs the card."""
    _fake_bwd_route(monkeypatch, [route_code])
    t, g = _bf16_bwd_operands(misalign=True)
    assert t["rpe"].is_contiguous() and t["rpe"].data_ptr() % 16
    call = lambda: knarpe._launch_bwd("knarpe_cross_attention", t["q"], None, None, t["tgt"], t["rpe"], t["invalid"],
                                      t["w_kv"], t["w_rpe"], t["b"], g, N_HEAD)
    if route_code == 0:
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    else:
        def no_card():
            raise RuntimeError("no card")

        monkeypatch.setattr(knarpe, "load_bwd_library", no_card)
        with pytest.raises(RuntimeError, match="no card"):
            call()


def _fake_attn_bwd_route(monkeypatch, codes):
    """Fake the built library's answer for B4-bwd (`attn_bwd_staged_refusal`); -> the calls, in order."""
    asked = []

    def answer(n_knn, d_model, d_rpe, n_head, device_index):
        asked.append((n_knn, d_model, d_rpe, n_head, device_index))
        return codes[0]

    monkeypatch.setattr(knarpe, "attn_bwd_staged_refusal", answer)
    return asked


@pytest.mark.parametrize("code", [0, *sorted(knarpe.ATTN_BWD_STAGED_REFUSALS)])
def test_bwd_route_sends_bf16_attention_by_the_staged_code(code, monkeypatch):
    """bf16 B4-bwd takes the staged B4 backward where the built library's answer is 0 and the general
    kernel for each refusal code, asked from the shape alone (not B2's answer); float32 B4-bwd takes the
    general kernel without asking."""
    asked = _fake_attn_bwd_route(monkeypatch, [code])
    asked_b2 = _fake_bwd_route(monkeypatch, [0])
    want = "staged" if code == 0 else "general"
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, 32, 128, 128, 4, 0) == want
    assert asked == [(32, 128, 128, 4, 0)] and asked_b2 == []
    asked.clear()
    assert knarpe.bwd_route("knarpe_attention", torch.float32, 32, 128, 128, 4, 0) == "general"
    assert asked == []


def test_attention_bwd_refusals_name_each_code():
    """One text per refusal code of `staged_attn_bwd::refusal` (1-4) and the plan's no-fit (5), each its own."""
    texts = knarpe.ATTN_BWD_STAGED_REFUSALS
    assert sorted(texts) == [1, 2, 3, 4, 5]
    assert len(set(texts.values())) == len(texts) and all(texts.values())
    assert "128" in texts[1] and "16" in texts[2] and "n_head" in texts[3] and "shared memory" in texts[4]


def _bf16_attn_bwd_operands(misalign):
    args, g = _inputs(2, 3, 5, seed=5, cross=False)
    t = {k: torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(torch.bfloat16) for k, v in args.items()}
    if misalign == "q":  # the same values one element into a buffer: contiguous, 2 bytes off a 16-byte boundary
        buf = torch.zeros(t["q"].numel() + 1, dtype=torch.bfloat16)
        buf[1:] = t["q"].reshape(-1)
        t["q"] = buf[1:].view(t["q"].shape)
    elif misalign == "ld_kv":  # k and v rows of a [.., 2D + 4] buffer: 8 bytes off a multiple of 16 apart
        buf = torch.zeros(*t["k"].shape[:-1], 2 * D + 4, dtype=torch.bfloat16)
        buf[..., :D], buf[..., D:2 * D] = t["k"], t["v"]
        t["k"], t["v"] = buf[..., :D], buf[..., D:2 * D]
    return t, torch.from_numpy(g).to(torch.bfloat16)


@pytest.mark.parametrize("route_code", [0, 4])
@pytest.mark.parametrize("misalign,match", [("q", "16-byte aligned"), ("ld_kv", "multiple of 16 bytes")])
def test_launch_bwd_raises_for_misaligned_bf16_attention_operands_on_the_staged_route(misalign, match, route_code,
                                                                                      monkeypatch):
    """At a shape the staged B4 backward takes, an operand off a 16-byte boundary or k/v rows 8 bytes off a
    multiple of 16 bytes apart raise before any launch; on the general route neither check applies, and
    the launch itself needs the card."""
    _fake_attn_bwd_route(monkeypatch, [route_code])
    t, g = _bf16_attn_bwd_operands(misalign)
    call = lambda: knarpe._launch_bwd("knarpe_attention", t["q"], t["k"], t["v"], None, t["rpe"], t["invalid"], None,
                                      t["w_rpe"], t["b_rpe"], g, N_HEAD)
    if route_code == 0:
        with pytest.raises(ValueError, match=match):
            call()
    else:
        def no_card():
            raise RuntimeError("no card")

        monkeypatch.setattr(knarpe, "load_bwd_library", no_card)
        with pytest.raises(RuntimeError, match="no card"):
            call()


def _fake_x_bwd_heads_route(monkeypatch, code):
    """Fake the built library's answers for B2-bwd at the scaled preset's widths: the staged backward refuses (more
    than 4 heads, code 3), the heads backward answers `code` (`x_bwd_heads_refusal`); -> its calls, in order."""
    _fake_bwd_route(monkeypatch, [3])
    asked = []

    def answer(n_knn, d_model, d_rpe, n_head, device_index):
        asked.append((n_knn, d_model, d_rpe, n_head, device_index))
        return code

    monkeypatch.setattr(knarpe, "x_bwd_heads_refusal", answer)
    return asked


@pytest.mark.parametrize("n_knn", [24, 89])
def test_bwd_route_sends_bf16_b2_at_the_scaled_widths_to_the_heads_kernel(n_knn, monkeypatch):
    """bf16 B2-bwd (B3's backward too) at D=R=256 with 8 heads, which the staged backward refuses, takes the heads
    kernel where the built library's answer is 0, asked from the shape alone, at both scaled training shapes' K;
    float32 takes the general kernel without asking."""
    asked = _fake_x_bwd_heads_route(monkeypatch, 0)
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, n_knn, 256, 256, 8, 0) == "heads"
    assert asked == [(n_knn, 256, 256, 8, 0)]
    asked.clear()
    assert knarpe.bwd_route("knarpe_cross_attention", torch.float32, n_knn, 256, 256, 8, 0) == "general"
    assert asked == []


@pytest.mark.parametrize("code", sorted(knarpe.X_BWD_HEADS_REFUSALS))
def test_bwd_route_sends_each_x_heads_refusal_to_the_general_kernel(code, monkeypatch):
    """Every refusal code of the heads B2 backward sends bf16 B2-bwd to the general kernel; eight heads at other
    widths and the flagship's four heads take their routes without asking it (it is compiled for D=R=256 with 8 heads
    only); B4's backward at the scaled widths asks its own heads backward, never this one."""
    asked = _fake_x_bwd_heads_route(monkeypatch, code)
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 129, 256, 256, 8, 0) == "general"
    assert asked == [(129, 256, 256, 8, 0)]
    asked.clear()
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 89, 32, 16, 8, 0) == "general"
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 89, 128, 128, 4, 0) == "general"
    asked_b4 = _fake_attn_bwd_heads_route(monkeypatch, 0)
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, 32, 256, 256, 8, 0) == "heads"
    assert asked == [] and asked_b4 == [(32, 256, 256, 8, 0)]


def test_x_bwd_heads_refusals_name_each_code():
    """One text per refusal code of `heads_x_bwd::refusal` (1-3) and the plan's no-fit (4), each its own, and the
    route counted under its own key."""
    texts = knarpe.X_BWD_HEADS_REFUSALS
    assert sorted(texts) == [1, 2, 3, 4]
    assert len(set(texts.values())) == len(texts) and all(texts.values())
    assert "128" in texts[1] and "256" in texts[2] and "shared memory" in texts[3] and "multiprocessor" in texts[4]
    assert knarpe.ROUTE_LAUNCHES["knarpe_cross_attention_bwd/heads"] >= 0


@pytest.mark.parametrize("route_code", [0, 1])
@pytest.mark.parametrize("operand", ["tgt", "rpe", "g"])
def test_launch_bwd_raises_for_misaligned_bf16_operands_on_the_x_heads_route(operand, route_code, monkeypatch):
    """At a shape the heads B2 backward takes (D=R=256, 8 heads), an operand off a 16-byte boundary raises before any
    launch, naming the route; where it refuses the shape, the general route has no such check, and the launch itself
    needs the card."""
    _fake_x_bwd_heads_route(monkeypatch, route_code)
    d, r, n_head = 256, 256, 8
    rng = np.random.default_rng(10)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    t = dict(q=f(1, 3, d), tgt=f(1, 3, 5, d), rpe=f(1, 3, 5, r), w_kv=f(d, 2 * d), w_rpe=f(r, 2 * d), b=f(2 * d),
             g=f(1, 3, d))
    buf = torch.zeros(t[operand].numel() + 1, dtype=torch.bfloat16)  # contiguous, 2 bytes off a 16-byte boundary
    buf[1:] = t[operand].reshape(-1)
    t[operand] = buf[1:].view(t[operand].shape)
    inv = torch.zeros(1, 3, 5, dtype=torch.bool)
    call = lambda: knarpe._launch_bwd("knarpe_cross_attention", t["q"], None, None, t["tgt"], t["rpe"], inv, t["w_kv"],
                                      t["w_rpe"], t["b"], t["g"], n_head)
    if route_code == 0:
        with pytest.raises(ValueError, match="the heads bf16 kernel .*16-byte aligned"):
            call()
    else:
        def no_card():
            raise RuntimeError("no card")

        monkeypatch.setattr(knarpe, "load_bwd_library", no_card)
        with pytest.raises(RuntimeError, match="no card"):
            call()


def _fake_attn_bwd_heads_route(monkeypatch, code):
    """Fake the built library's answers for B4-bwd at the scaled preset's widths: the staged backward refuses (more
    than 4 heads, code 3), the heads backward answers `code` (`attn_bwd_heads_refusal`); -> its calls, in order."""
    _fake_attn_bwd_route(monkeypatch, [3])
    asked = []

    def answer(n_knn, d_model, d_rpe, n_head, device_index):
        asked.append((n_knn, d_model, d_rpe, n_head, device_index))
        return code

    monkeypatch.setattr(knarpe, "attn_bwd_heads_refusal", answer)
    return asked


def test_bwd_route_sends_bf16_attention_at_the_scaled_widths_to_the_heads_kernel(monkeypatch):
    """bf16 B4-bwd at D=R=256 with 8 heads, which the staged backward refuses, takes the heads kernel where the
    built library's answer is 0, asked from the shape alone; float32 takes the general kernel without asking."""
    asked = _fake_attn_bwd_heads_route(monkeypatch, 0)
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, 32, 256, 256, 8, 0) == "heads"
    assert asked == [(32, 256, 256, 8, 0)]
    asked.clear()
    assert knarpe.bwd_route("knarpe_attention", torch.float32, 32, 256, 256, 8, 0) == "general"
    assert asked == []


@pytest.mark.parametrize("code", sorted(knarpe.ATTN_BWD_HEADS_REFUSALS))
def test_bwd_route_sends_each_heads_refusal_to_the_general_kernel(code, monkeypatch):
    """Every refusal code of the heads backward sends bf16 B4-bwd to the general kernel; eight heads at other widths
    take the general kernel without asking the heads backward (it is compiled for D=R=256 with 8 heads only); B2's
    backward at the scaled widths never asks it (it asks its own heads backward, here refusing)."""
    asked = _fake_attn_bwd_heads_route(monkeypatch, code)
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, 48, 256, 256, 8, 0) == "general"
    assert asked == [(48, 256, 256, 8, 0)]
    asked.clear()
    assert knarpe.bwd_route("knarpe_attention", torch.bfloat16, 89, 32, 16, 8, 0) == "general"
    asked_x = _fake_x_bwd_heads_route(monkeypatch, 1)
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 129, 256, 256, 8, 0) == "general"
    assert asked == [] and asked_x == [(129, 256, 256, 8, 0)]


def test_attention_bwd_heads_refusals_name_each_code():
    """One text per refusal code of `heads_attn_bwd::refusal` (1-3) and the plan's no-fit (4), each its own, and the
    route counted under its own key."""
    texts = knarpe.ATTN_BWD_HEADS_REFUSALS
    assert sorted(texts) == [1, 2, 3, 4]
    assert len(set(texts.values())) == len(texts) and all(texts.values())
    assert "64" in texts[1] and "256" in texts[2] and "shared memory" in texts[3] and "multiprocessor" in texts[4]
    assert knarpe.ROUTE_LAUNCHES["knarpe_attention_bwd/heads"] >= 0


@pytest.mark.parametrize("route_code", [0, 3])
@pytest.mark.parametrize("misalign,match", [("q", "16-byte aligned"), ("ld_kv", "multiple of 16 bytes")])
def test_launch_bwd_raises_for_misaligned_bf16_attention_operands_on_the_heads_route(misalign, match, route_code,
                                                                                     monkeypatch):
    """At a shape the heads B4 backward takes (D=R=256, 8 heads), an operand off a 16-byte boundary or k/v rows 8
    bytes off a multiple of 16 bytes apart raise before any launch, naming the route; where it refuses the shape, the
    general route has neither check, and the launch itself needs the card."""
    _fake_attn_bwd_heads_route(monkeypatch, route_code)
    d, r, n_head = 256, 256, 8
    rng = np.random.default_rng(9)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    q, rpe, w, b, g = f(1, 3, d), f(1, 3, 5, r), f(r, 2 * d), f(2 * d), f(1, 3, d)
    inv = torch.zeros(1, 3, 5, dtype=torch.bool)
    if misalign == "q":  # the same values one element into a buffer: contiguous, 2 bytes off a 16-byte boundary
        buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
        buf[1:] = q.reshape(-1)
        q = buf[1:].view(q.shape)
        k, v = f(1, 3, 5, 2 * d).chunk(2, -1)
    else:  # k and v rows of a [.., 2D + 4] buffer: 8 bytes off a multiple of 16 apart
        buf = f(1, 3, 5, 2 * d + 4)
        k, v = buf[..., :d], buf[..., d:2 * d]
    call = lambda: knarpe._launch_bwd("knarpe_attention", q, k, v, None, rpe, inv, None, w, b, g, n_head)
    if route_code == 0:
        with pytest.raises(ValueError, match=f"the heads bf16 kernel .*{match}"):
            call()
    else:
        def no_card():
            raise RuntimeError("no card")

        monkeypatch.setattr(knarpe, "load_bwd_library", no_card)
        with pytest.raises(RuntimeError, match="no card"):
            call()


# pose_rpe "xy_dir"'s 4-wide RPE at the flagship's widths (K=89, D=128, H=4) and the phase-4 config's (K=11, D=64, H=2)
RPE4_SHAPES = [(89, 128, 4, 4), (11, 64, 4, 2)]
R_NARROW = 4


def _fake_fwd_routes(monkeypatch, staged, cluster=2, general=0):
    """Fake the built library's answers for a bf16 B2/B3 forward (`staged_refusal`, `cluster_refusal`,
    `v3_heads_refusal`, `general_refusal`); -> the calls, in order."""
    asked = []

    def answer(which, code):
        def fn(*shape):
            asked.append((which, *shape))
            return code
        return fn

    monkeypatch.setattr(knarpe, "staged_refusal", answer("staged", staged))
    monkeypatch.setattr(knarpe, "cluster_refusal", answer("cluster", cluster))
    monkeypatch.setattr(knarpe, "v3_heads_refusal", answer("heads", cluster))
    monkeypatch.setattr(knarpe, "general_refusal", answer("general", general))
    return asked


@pytest.mark.parametrize("name", ["knarpe_cross_attention", "knarpe_cross_attention_v3"])
@pytest.mark.parametrize("shape", RPE4_SHAPES)
def test_route_sends_bf16_b2_at_rpe4_to_the_staged_kernel(name, shape, monkeypatch):
    """bf16 B2 (and B3) at d_rpe = 4 takes the staged kernel where the library's answer is 0, asked from the shape
    alone with the 4-wide rpe; neither the cluster nor the general kernel is asked."""
    asked = _fake_fwd_routes(monkeypatch, staged=0)
    assert knarpe.route(name, torch.bfloat16, *shape, 0) == "staged"
    assert asked == [("staged", name, *shape, 0)]


@pytest.mark.parametrize("shape", RPE4_SHAPES)
def test_bwd_route_sends_bf16_b2_at_rpe4_to_the_staged_kernel(shape, monkeypatch):
    """bf16 B2-bwd (B3's backward too) at d_rpe = 4 takes the staged backward where the library's answer is 0."""
    asked = _fake_bwd_route(monkeypatch, [0])
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, *shape, 0) == "staged"
    assert knarpe.bwd_route("knarpe_cross_attention_v3", torch.bfloat16, *shape, 0) == "staged"
    assert asked == [(*shape, 0)] * 2


@pytest.mark.parametrize("shape", RPE4_SHAPES)
def test_float32_at_rpe4_takes_the_general_kernels(shape, monkeypatch):
    """float32 B2, B3 and their backward at d_rpe = 4 take the general kernels without asking the library."""
    asked = _fake_fwd_routes(monkeypatch, staged=0)
    asked_bwd = _fake_bwd_route(monkeypatch, [0])
    for name in ("knarpe_cross_attention", "knarpe_cross_attention_v3"):
        assert knarpe.route(name, torch.float32, *shape, 0) == "general"
        assert knarpe.bwd_route(name, torch.float32, *shape, 0) == "general"
    assert asked == [] and asked_bwd == []


@pytest.mark.parametrize("d_rpe", [8, 12, 20])
def test_a_narrow_width_the_staged_route_refuses_says_why(d_rpe, monkeypatch):
    """A d_rpe that is neither 4 nor a multiple of 16 is the staged kernels' refusal code 2, whose words name the widths
    they take: such a bf16 B2 takes the general kernel where it takes the shape and raises, saying why, where it does
    not; its backward takes the general backward."""
    words = knarpe.STAGED_REFUSALS[2]
    assert "d_rpe a multiple of 16 or 4" in words and words == knarpe.BWD_STAGED_REFUSALS[2]
    _fake_fwd_routes(monkeypatch, staged=2)
    assert knarpe.route("knarpe_cross_attention", torch.bfloat16, 89, 128, d_rpe, 4, 0) == "general"
    _fake_fwd_routes(monkeypatch, staged=2, general=1)
    with pytest.raises(ValueError, match=r"d_rpe a multiple of 16 or 4"):
        knarpe.route("knarpe_cross_attention", torch.bfloat16, 89, 128, d_rpe, 4, 0)
    _fake_bwd_route(monkeypatch, [2])
    assert knarpe.bwd_route("knarpe_cross_attention", torch.bfloat16, 89, 128, d_rpe, 4, 0) == "general"


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_rpe4_operands_off_16_bytes_raise_on_the_staged_route(backward, monkeypatch):
    """At d_rpe = 4 on the staged route the 8-byte rpe rows are copied from a 16-byte aligned base: an rpe 2 bytes off
    a 16-byte boundary raises before any launch, forward and backward."""
    _fake_fwd_routes(monkeypatch, staged=0)
    _fake_bwd_route(monkeypatch, [0])
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    d, n_head = 64, 2
    q, tgt, w_kv, w_rpe, b, g = f(1, 3, d), f(1, 3, 11, d), f(d, 2 * d), f(R_NARROW, 2 * d), f(2 * d), f(1, 3, d)
    buf = torch.zeros(3 * 11 * R_NARROW + 1, dtype=torch.bfloat16)
    rpe = buf[1:].view(1, 3, 11, R_NARROW)
    assert rpe.is_contiguous() and rpe.data_ptr() % 16
    inv = torch.zeros(1, 3, 11, dtype=torch.bool)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if backward:
            knarpe._launch_bwd("knarpe_cross_attention", q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, n_head)
        else:
            knarpe._launch("knarpe_cross_attention", q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, n_head)
