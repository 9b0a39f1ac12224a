"""PyTorch port: the KNARPE attention kernels' plain versions against the TPU kernels.

The port's `ops/knarpe.py` plain versions of B4 (`knarpe_attention`), B2
(`knarpe_cross_attention`) and B3 (`knarpe_cross_attention_v3`) are held
against `trafficbotsv15_tpu/ops/pallas_knarpe.py`: the Pallas kernels in
interpret mode (as `tests/test_pallas_knarpe.py` runs them) and the JAX
`*_reference` functions. Inputs come from a numpy seed; sizes are small
(B=2, S in {7, 8, 33}, K in {4, 5, 89}, H=2, d_head=8, R=16), and two wider
cases take shapes the staged bf16 kernels refuse on the card (H=8 with
d_head=32 and D=R=256 at K=89, where bf16 B2 takes the cluster route and B3
the general one; K=90 at D=R=128, H=4, the general route; measured within 1.2e-6
in float32 and 3.2e-2 in bfloat16, under the tolerances below); every case
has a source whose targets are all invalid and partly invalid sources, and
B*S=66 is not a multiple of the Pallas source tile.

Outputs are of size up to ~6. Tolerances:
  - float32, plain version vs the JAX reference (same ops in the same
    order): 5e-6, float32 rounding of another library only (measured
    <= 1.7e-6);
  - float32, vs the interpret-mode kernels (per-head sums as segment
    matmuls): 1e-5, reduction order only (measured <= 2.7e-6);
  - bfloat16, B2/B4 vs the interpret-mode kernels, which compute in float32
    inside while the plain versions round every op to bf16: 6e-2, two bf16
    ulps at |out| < 8 (measured <= 3.9e-2);
  - bfloat16, B3 vs the interpret-mode v3 kernel, whose roundings the plain
    version repeats: 3.2e-2, one ulp, for a rounding of kk or q*k that a
    different f32 summation order flips (measured 0).
The output of an all-invalid source is exactly zero.
"""

import contextlib
import re

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
F32_REF_ATOL, F32_KERNEL_ATOL, BF16_ATOL, BF16_V3_ATOL = 5e-6, 1e-5, 6e-2, 3.2e-2
SHAPES = [(2, 7, 4), (2, 8, 5), (2, 33, 89)]


def _inputs(n_b, n_s, n_knn, seed, cross):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    inv = rng.uniform(size=(n_b, n_s, n_knn)) < 0.3
    inv[0, 1] = True  # a source with no valid target
    inv[1, 0, :-1] = True  # a source with one valid target
    if cross:
        return dict(q=f(n_b, n_s, D), tgt=f(n_b, n_s, n_knn, D), rpe=f(n_b, n_s, n_knn, R), invalid=inv,
                    w_kv=0.3 * f(D, 2 * D), w_rpe=0.3 * f(R, 2 * D), b=0.1 * f(2 * D))
    return dict(q=f(n_b, n_s, D), k=f(n_b, n_s, n_knn, D), v=f(n_b, n_s, n_knn, D), rpe=f(n_b, n_s, n_knn, R),
                invalid=inv, w_rpe=0.3 * f(R, 2 * D), b_rpe=0.1 * f(2 * D))


def _cast(args, jdt, tdt):
    j = {k: jnp.asarray(v) if v.dtype == bool else jnp.asarray(v).astype(jdt) for k, v in args.items()}
    t = {k: torch.from_numpy(v) if v.dtype == bool else torch.from_numpy(v).to(tdt) for k, v in args.items()}
    return j, t


KERNELS = {  # name -> (cross?, JAX kernel, JAX reference, port plain version)
    "knarpe_attention": (False, jk.knarpe_attention, jk.knarpe_attention_reference,
                         knarpe.knarpe_attention_reference),
    "knarpe_cross_attention": (True, jk.knarpe_cross_attention, jk.knarpe_cross_attention_reference,
                               knarpe.knarpe_cross_attention_reference),
    "knarpe_cross_attention_v3": (True, jk.knarpe_cross_attention_v3, jk.knarpe_cross_attention_reference,
                                  knarpe.knarpe_cross_attention_v3_reference),
}


def _jax_out(fn, j, n_b, n_s, **kw):
    return np.asarray(fn(*j.values(), N_HEAD, **kw), dtype=np.float32).reshape(n_b, n_s, D)


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("n_b,n_s,n_knn", SHAPES)
def test_plain_version_matches_tpu_kernel_f32(name, n_b, n_s, n_knn):
    cross, jkern, jref, plain = KERNELS[name]
    args = _inputs(n_b, n_s, n_knn, seed=n_s * 100 + n_knn, cross=cross)
    j, t = _cast(args, jnp.float32, torch.float32)
    got = t2n(plain(*t.values(), N_HEAD))
    assert got.shape == (n_b, n_s, D)
    np.testing.assert_allclose(got, _jax_out(jref, j, n_b, n_s), rtol=0, atol=F32_REF_ATOL)
    np.testing.assert_allclose(got, _jax_out(jkern, j, n_b, n_s, interpret=True), rtol=0, atol=F32_KERNEL_ATOL)
    np.testing.assert_array_equal(got[0, 1], 0.0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("n_b,n_s,n_knn", SHAPES[1:])
def test_plain_version_matches_tpu_kernel_bf16(name, n_b, n_s, n_knn):
    cross, jkern, _, plain = KERNELS[name]
    args = _inputs(n_b, n_s, n_knn, seed=n_s * 100 + n_knn + 1, cross=cross)
    j, t = _cast(args, jnp.bfloat16, torch.bfloat16)
    out = plain(*t.values(), N_HEAD)
    assert out.dtype == torch.bfloat16
    got = t2n(out)
    want = _jax_out(jkern, j, n_b, n_s, interpret=True)
    atol = BF16_V3_ATOL if name.endswith("_v3") else BF16_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got[0, 1], 0.0)


# Wider than the cases above: the scaled preset's heads (H=8, d_head=32, D=R=256) and K=90 at the
# flagship's D=R=128, H=4, two shapes the staged bf16 kernel refuses (on the card bf16 B2 takes the
# cluster route at the first, tests/test_torch_knarpe_cluster.py holding that kernel's arithmetic; B3 at
# both and B2 at the second the general route). (n_head, d_head, R, n_b, n_s, K); weights scaled by 1/sqrt(fan-in), outputs of size ~1-3.
WIDE = [(8, 32, 256, 1, 9, 89), (4, 32, 128, 2, 5, 90)]


def _wide_inputs(n_head, d_head, r, n_b, n_s, n_knn, seed, cross):
    d = n_head * d_head
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    inv = rng.uniform(size=(n_b, n_s, n_knn)) < 0.3
    inv[0, 1] = True  # a source with no valid target
    inv[-1, 0, :-1] = True  # a source with one valid target
    w_rpe, b = f(r, 2 * d, scale=r ** -0.5), f(2 * d, scale=0.1)
    if cross:
        return dict(q=f(n_b, n_s, d), tgt=f(n_b, n_s, n_knn, d), rpe=f(n_b, n_s, n_knn, r), invalid=inv,
                    w_kv=f(d, 2 * d, scale=d ** -0.5), w_rpe=w_rpe, b=b)
    return dict(q=f(n_b, n_s, d), k=f(n_b, n_s, n_knn, d), v=f(n_b, n_s, n_knn, d), rpe=f(n_b, n_s, n_knn, r),
                invalid=inv, w_rpe=w_rpe, b_rpe=b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("n_head,d_head,r,n_b,n_s,n_knn", WIDE)
def test_plain_version_matches_tpu_kernel_at_wider_shapes(name, n_head, d_head, r, n_b, n_s, n_knn, dtype):
    cross, jkern, jref, plain = KERNELS[name]
    d = n_head * d_head
    args = _wide_inputs(n_head, d_head, r, n_b, n_s, n_knn, seed=d + n_knn, cross=cross)
    j, t = _cast(args, getattr(jnp, dtype), getattr(torch, dtype))
    out = plain(*t.values(), n_head)
    assert out.dtype == getattr(torch, dtype) and out.shape == (n_b, n_s, d)
    got = t2n(out)
    want = np.asarray(jkern(*j.values(), n_head, interpret=True), dtype=np.float32).reshape(n_b, n_s, d)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_KERNEL_ATOL)
        ref = np.asarray(jref(*j.values(), n_head), dtype=np.float32).reshape(n_b, n_s, d)
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_REF_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_V3_ATOL if name.endswith("_v3") else BF16_ATOL)
    np.testing.assert_array_equal(got[0, 1], 0.0)
    assert np.isfinite(got).all()


def test_v3_rounds_where_the_tpu_kernel_rounds():
    """In bf16 the v3 plain version is closer to the v3 kernel than B2's plain
    version is: it repeats the kernel's roundings and nothing else."""
    args = _inputs(2, 33, 89, seed=5, cross=True)
    j, t = _cast(args, jnp.bfloat16, torch.bfloat16)
    want = _jax_out(jk.knarpe_cross_attention_v3, j, 2, 33, interpret=True)
    err_v3 = np.abs(t2n(knarpe.knarpe_cross_attention_v3_reference(*t.values(), N_HEAD)) - want).max()
    err_v2 = np.abs(t2n(knarpe.knarpe_cross_attention_reference(*t.values(), N_HEAD)) - want).max()
    assert err_v3 < err_v2


@pytest.mark.parametrize("name", list(KERNELS))
def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing(name):
    cross, _, _, plain = KERNELS[name]
    _, t = _cast(_inputs(2, 8, 5, seed=3, cross=cross), jnp.float32, torch.float32)
    before = dict(knarpe.LAUNCHES)
    out = getattr(knarpe, name)(*t.values(), N_HEAD)
    assert knarpe.LAUNCHES == before
    assert torch.equal(out, plain(*t.values(), N_HEAD))


def test_attention_takes_the_halves_of_one_projection():
    """The map encoder hands B4 the k and v halves of one gathered [.., 2D] tensor."""
    args = _inputs(2, 8, 5, seed=4, cross=False)
    _, t = _cast(args, jnp.float32, torch.float32)
    kv = torch.cat([t["k"], t["v"]], -1)
    k, v = kv.chunk(2, -1)
    assert not k.is_contiguous()
    out = knarpe.knarpe_attention(t["q"], k, v, t["rpe"], t["invalid"], t["w_rpe"], t["b_rpe"], N_HEAD)
    assert torch.equal(out, knarpe.knarpe_attention_reference(*t.values(), N_HEAD))
    assert knarpe._row_stride("knarpe_attention", "k", k, k.shape, k.dtype, k.device) == 2 * D


def test_wrappers_raise_off_cpu_without_kernel():
    _, t = _cast(_inputs(2, 2, 3, seed=0, cross=True), jnp.float32, torch.float32)
    meta = {k: v.to("meta") for k, v in t.items()}
    for name in ("knarpe_cross_attention", "knarpe_cross_attention_v3"):
        with pytest.raises(ValueError, match="no kernel for device"):
            getattr(knarpe, name)(*meta.values(), N_HEAD)


def _bf16_cross(n_knn, d, r, misalign=False):
    t = _cast(_inputs(2, 3, n_knn, seed=0, cross=True), jnp.float32, torch.float32)[1]
    if d != D or r != R:
        rng = np.random.default_rng(1)
        f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
        t = dict(q=f(2, 3, d), tgt=f(2, 3, n_knn, d), rpe=f(2, 3, n_knn, r), invalid=t["invalid"],
                 w_kv=f(d, 2 * d), w_rpe=f(r, 2 * d), b=f(2 * d))
    t = {k: v if v.dtype == torch.bool else v.to(torch.bfloat16) for k, v in t.items()}
    if misalign:  # the same values one element into a buffer: contiguous, 2 bytes off a 16-byte boundary
        buf = torch.zeros(t["tgt"].numel() + 1, dtype=torch.bfloat16)
        buf[1:] = t["tgt"].reshape(-1)
        t["tgt"] = buf[1:].view(t["tgt"].shape)
    return t


def _validate(name, t, n_head):
    return knarpe._validate(name, t["q"], None, None, t["tgt"], t["rpe"], t["invalid"], t["w_kv"], t["w_rpe"],
                            t["b"], n_head)


CROSS_KERNELS = ["knarpe_cross_attention", "knarpe_cross_attention_v3"]


def _fake_routes(monkeypatch, staged, general, cluster=(2,), heads=(2,)):
    """Fake the built library's answers (`staged_refusal`, `general_refusal`, B2's `cluster_refusal` and B4's
    `heads_refusal`, which refuse unless told otherwise); -> the calls, in order."""
    asked = []

    def answer(which, codes):
        def fn(kernel, n_knn, d_model, d_rpe, n_head, device_index):
            asked.append((which, kernel, n_knn, d_model, d_rpe, n_head, device_index))
            return codes[0]
        return fn

    monkeypatch.setattr(knarpe, "staged_refusal", answer("staged", staged))
    monkeypatch.setattr(knarpe, "general_refusal", answer("general", general))
    cluster_fn = answer("cluster", cluster)
    monkeypatch.setattr(knarpe, "cluster_refusal", lambda *shape: cluster_fn("knarpe_cross_attention", *shape))
    heads_fn = answer("heads", heads)
    monkeypatch.setattr(knarpe, "heads_refusal", lambda *shape: heads_fn("knarpe_attention", *shape))
    return asked


@pytest.mark.parametrize("name", CROSS_KERNELS)
def test_validate_routes_each_staged_refusal_to_the_general_kernel(name, monkeypatch):
    """bf16 B2 and B3 take the staged kernel where it takes the shape, and the general kernel for
    every shape it refuses, whatever the reason: the route follows from the shape, asked of the built
    library before any launch, and `_validate` names it. The general route needs no 16-byte alignment."""
    staged, general = [0], [0]
    asked = _fake_routes(monkeypatch, staged, general)
    t = _bf16_cross(5, 32, 16)
    assert _validate(name, t, 2) == (2, 3, 5, 32, 16, 32, 0, "staged")
    assert asked == [("staged", name, 5, 32, 16, 2, 0)]
    # B2 asks the cluster kernel between the two (refusing here), B3 does not
    between = [("cluster", name, 5, 32, 16, 2, 0)] if name == "knarpe_cross_attention" else []
    for code in knarpe.STAGED_REFUSALS:
        staged[0] = code
        asked.clear()
        assert _validate(name, t, 2)[-1] == "general"
        assert asked == [("staged", name, 5, 32, 16, 2, 0), *between, ("general", name, 5, 32, 16, 2, 0)]
    misaligned = _bf16_cross(5, 32, 16, misalign=True)
    assert misaligned["tgt"].data_ptr() % 16 and _validate(name, misaligned, 2)[-1] == "general"


@pytest.mark.parametrize("name", CROSS_KERNELS)
def test_validate_raises_for_shapes_the_staged_kernel_refuses(name, monkeypatch):
    """A bf16 B2/B3 shape that the staged kernel refuses raises when the general kernel refuses it too,
    naming both reasons; float32 (always the general kernel) and the backward do not ask either."""
    asked = _fake_routes(monkeypatch, [0], [1])
    t = _bf16_cross(5, 32, 16)
    assert _validate(name, t, 2)[:5] == (2, 3, 5, 32, 16) and asked == [("staged", name, 5, 32, 16, 2, 0)]
    cluster = (f", the cluster kernel too ({knarpe.CLUSTER_REFUSALS[2]})" if name == "knarpe_cross_attention"
               else "")
    for code, why in knarpe.STAGED_REFUSALS.items():
        _fake_routes(monkeypatch, [code], [1])
        want = (f"no bf16 kernel takes K=5, d_model=32, d_rpe=16, n_head=2: the staged kernel refuses it ({why})"
                f"{cluster}, and the general kernel too ({knarpe.GENERAL_REFUSALS[1]})")
        with pytest.raises(ValueError, match=re.escape(want)):
            _validate(name, t, 2)
    asked = _fake_routes(monkeypatch, [5], [1])
    t32 = {k: v if v.dtype == torch.bool else v.float() for k, v in t.items()}
    assert _validate(name, t32, 2) == (2, 3, 5, 32, 16, 32, 0, "general")
    assert knarpe._validate(name, t["q"], None, None, t["tgt"], t["rpe"], t["invalid"], t["w_kv"], t["w_rpe"],
                            t["b"], 2, forward=False)[-1] is None
    assert asked == []


@pytest.mark.parametrize("name", CROSS_KERNELS)
def test_validate_raises_for_misaligned_bf16_operands(name, monkeypatch):
    """The staged kernel copies 16-byte chunks: a bf16 operand 2 bytes off a 16-byte boundary at a
    shape the staged kernel takes raises (the route follows from the shape, not from the addresses);
    float32 runs on the general kernel."""
    _fake_routes(monkeypatch, [0], [0])
    misaligned = _bf16_cross(5, D, R, misalign=True)
    assert misaligned["tgt"].is_contiguous() and misaligned["tgt"].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        _validate(name, misaligned, N_HEAD)
    t32 = {k: v if v.dtype == torch.bool else v.float() for k, v in misaligned.items()}
    t32["tgt"] = torch.zeros(t32["tgt"].numel() + 1)[1:].view(t32["tgt"].shape)
    assert t32["tgt"].data_ptr() % 16
    assert _validate(name, t32, N_HEAD)[:4] == (2, 3, 5, D)


@pytest.mark.parametrize("name,widths,staged,want", [
    ("knarpe_cross_attention", (128, 128, 4), 0, "staged"),
    ("knarpe_cross_attention", (256, 256, 8), 5, "cluster"),
    ("knarpe_cross_attention_v3", (256, 256, 8), 5, "general")])
def test_validate_routes_bf16_cross_attention_by_widths(name, widths, staged, want, monkeypatch):
    """The flagship's D=R=128, H=4, where the staged kernel takes the shape, stays staged, the cluster kernel not
    asked; at the scaled preset's D=R=256, H=8 the staged kernel refuses (its resident weights, code 5), and B2
    takes the cluster kernel, the general kernel not asked, where an operand off a 16-byte boundary raises, while
    B3 takes the general kernel without asking the cluster kernel."""
    d, r, n_head = widths
    asked = _fake_routes(monkeypatch, [staged], [0], cluster=[0])
    t = _bf16_cross(89, d, r)
    assert _validate(name, t, n_head) == (2, 3, 89, d, r, d, 0, want)
    ways = {"staged": ["staged"], "cluster": ["staged", "cluster"], "general": ["staged", "general"]}[want]
    assert asked == [(way, name, 89, d, r, n_head, 0) for way in ways]
    if want == "cluster":
        with pytest.raises(ValueError, match="the cluster bf16 kernel copies 16-byte chunks"):
            _validate(name, _bf16_cross(89, d, r, misalign=True), n_head)


@pytest.mark.parametrize("code", sorted(knarpe.CLUSTER_REFUSALS))
def test_validate_routes_each_cluster_refusal_to_the_general_kernel(code, monkeypatch):
    """A bf16 B2 shape the staged and cluster kernels refuse takes the general kernel, whatever the cluster
    kernel's reason; where the general kernel refuses it too, the error names each kernel's reason, the
    cluster kernel's by its own code's text."""
    name, t = "knarpe_cross_attention", _bf16_cross(89, 256, 256)
    asked = _fake_routes(monkeypatch, [5], [0], cluster=[code])
    assert _validate(name, t, 8)[-1] == "general"
    assert [a[0] for a in asked] == ["staged", "cluster", "general"]
    _fake_routes(monkeypatch, [5], [1], cluster=[code])
    want = (f"the staged kernel refuses it ({knarpe.STAGED_REFUSALS[5]}), the cluster kernel too "
            f"({knarpe.CLUSTER_REFUSALS[code]}), and the general kernel too ({knarpe.GENERAL_REFUSALS[1]})")
    with pytest.raises(ValueError, match=re.escape(want)):
        _validate(name, t, 8)


def _bf16_attn(misalign=None):
    """bf16 B4 operands on the CPU (D=16, R=16, K=5); misalign "rpe": rpe one element into a buffer (2 bytes
    off a 16-byte boundary); "ld_kv": k and v rows of a [.., 2D + 4] buffer (8 bytes off a multiple of 16)."""
    t = _cast(_inputs(2, 3, 5, seed=0, cross=False), jnp.float32, torch.float32)[1]
    t = {k: v if v.dtype == torch.bool else v.to(torch.bfloat16) for k, v in t.items()}
    if misalign == "rpe":
        buf = torch.zeros(t["rpe"].numel() + 1, dtype=torch.bfloat16)
        buf[1:] = t["rpe"].reshape(-1)
        t["rpe"] = buf[1:].view(t["rpe"].shape)
    elif misalign == "ld_kv":
        buf = torch.zeros(*t["k"].shape[:-1], 2 * D + 4, dtype=torch.bfloat16)
        buf[..., :D], buf[..., D:2 * D] = t["k"], t["v"]
        t["k"], t["v"] = buf[..., :D], buf[..., D:2 * D]
    return t


def _validate_attn(t, n_head=N_HEAD):
    return knarpe._validate("knarpe_attention", t["q"], t["k"], t["v"], None, t["rpe"], t["invalid"], None,
                            t["w_rpe"], t["b_rpe"], n_head)


@pytest.mark.parametrize("code", [0, *sorted(knarpe.ATTN_STAGED_REFUSALS)])
def test_validate_routes_bf16_attention_by_the_staged_code(code, monkeypatch):
    """bf16 B4 takes the staged kernel where the built library's answer is 0 and, for each refusal code,
    the heads kernel where it takes the shape and else the general kernel, asked from the shape alone (the
    heads kernel refuses here; the general kernel is not asked: it takes every B4 shape); float32 B4 takes
    the general kernel without asking."""
    asked = _fake_routes(monkeypatch, [code], [1])
    t = _bf16_attn()
    assert _validate_attn(t) == (2, 3, 5, D, R, 0, D, "staged" if code == 0 else "general")
    assert asked == [("staged", "knarpe_attention", 5, D, R, N_HEAD, 0)] + (
        [] if code == 0 else [("heads", "knarpe_attention", 5, D, R, N_HEAD, 0)])
    asked.clear()
    t32 = {k: v if v.dtype == torch.bool else v.float() for k, v in t.items()}
    assert _validate_attn(t32)[-1] == "general" and asked == []


def test_attention_refusals_name_each_code():
    """One text per refusal code of `staged_attn::refusal` (1-4) and the plan's no-fit (5), each its own."""
    texts = knarpe.ATTN_STAGED_REFUSALS
    assert sorted(texts) == [1, 2, 3, 4, 5]
    assert len(set(texts.values())) == len(texts) and all(texts.values())
    assert "128" in texts[1] and "16" in texts[2] and "n_head" in texts[3] and "shared memory" in texts[4]


@pytest.mark.parametrize("misalign,match", [("rpe", "16-byte aligned"), ("ld_kv", "multiple of 16 bytes")])
def test_validate_raises_for_misaligned_bf16_attention_operands(misalign, match, monkeypatch):
    """At a shape the staged B4 takes, an operand off a 16-byte boundary or k/v rows 8 bytes off a multiple
    of 16 bytes apart raise (the route follows from the shape, not from the addresses); on the general
    route neither check applies."""
    t = _bf16_attn(misalign)
    assert t["rpe"].data_ptr() % 16 if misalign == "rpe" else t["k"].stride(2) == 2 * D + 4
    _fake_routes(monkeypatch, [0], [1])
    with pytest.raises(ValueError, match=match):
        _validate_attn(t)
    _fake_routes(monkeypatch, [4], [1])
    assert _validate_attn(t)[-1] == "general"


def test_route_launches_count_attention_by_route_and_cpu_calls_count_none():
    """`ROUTE_LAUNCHES` has B4's and B4-bwd's routes beside B2's and B3's, B2's cluster route and B4's heads
    route; a CPU call, forward and backward, counts no launch on any route."""
    kernels = ("knarpe_attention", "knarpe_cross_attention", "knarpe_cross_attention_v3", "knarpe_attention_bwd",
               "knarpe_cross_attention_bwd")
    assert set(knarpe.ROUTE_LAUNCHES) == {f"{k}/{r}" for k in kernels for r in ("staged", "general")} | {
        "knarpe_cross_attention/cluster", "knarpe_attention/heads"}
    before, launches = dict(knarpe.ROUTE_LAUNCHES), dict(knarpe.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        t = {k: v if v.dtype == torch.bool else v.to(dtype).requires_grad_(True) for k, v in _bf16_attn().items()}
        knarpe.knarpe_attention(*t.values(), N_HEAD).float().sum().backward()
        assert t["k"].grad is not None
    assert knarpe.ROUTE_LAUNCHES == before and knarpe.LAUNCHES == launches


def _bf16_attn_scaled(misalign=None):
    """bf16 B4 operands on the CPU at the scaled preset's widths (D=R=256, 8 heads, K=32), k and v the halves
    of one [.., 2D] tensor; misalign "q": q one element into a buffer (2 bytes off a 16-byte boundary);
    "ld_kv": k and v rows of a [.., 2D + 4] buffer (8 bytes off a multiple of 16)."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    width = 2 * 256 + (4 if misalign == "ld_kv" else 0)
    kv = f(1, 3, 32, width)
    t = dict(q=f(1, 3, 256), k=kv[..., :256], v=kv[..., 256:512], rpe=f(1, 3, 32, 256),
             invalid=torch.from_numpy(rng.uniform(size=(1, 3, 32)) < 0.3), w_rpe=f(256, 512), b_rpe=f(512))
    if misalign == "q":
        buf = torch.zeros(t["q"].numel() + 1, dtype=torch.bfloat16)
        buf[1:] = t["q"].reshape(-1)
        t["q"] = buf[1:].view(t["q"].shape)
    return t


def test_validate_routes_bf16_attention_to_the_heads_kernel(monkeypatch):
    """At the scaled preset's widths the staged kernel refuses bf16 B4 (more than 4 heads, code 3) and the
    heads kernel takes it: the heads route, asked in that order from the shape alone, the general kernel not
    asked; float32 at the same shape takes the general kernel without asking either."""
    asked = _fake_routes(monkeypatch, [3], [1], heads=[0])
    t = _bf16_attn_scaled()
    assert _validate_attn(t, 8) == (1, 3, 32, 256, 256, 0, 512, "heads")
    assert asked == [(way, "knarpe_attention", 32, 256, 256, 8, 0) for way in ("staged", "heads")]
    asked.clear()
    t32 = {k: v if v.dtype == torch.bool else v.float() for k, v in t.items()}
    assert _validate_attn(t32, 8)[-1] == "general" and asked == []


@pytest.mark.parametrize("code", sorted(knarpe.HEADS_REFUSALS))
def test_validate_routes_each_heads_refusal_to_the_general_kernel(code, monkeypatch):
    """A bf16 B4 shape that the staged and heads kernels both refuse takes the general kernel, whatever the
    heads kernel's reason (the general kernel takes every B4 shape and is not asked); no alignment applies
    there."""
    asked = _fake_routes(monkeypatch, [3], [1], heads=[code])
    assert _validate_attn(_bf16_attn_scaled(), 8)[-1] == "general"
    assert [a[0] for a in asked] == ["staged", "heads"]
    assert _validate_attn(_bf16_attn_scaled("q"), 8)[-1] == "general"


def test_heads_refusals_name_each_code():
    """One text per refusal code of `heads_attn::refusal` (1-3) and the plan's no-fit (4), each its own."""
    texts = knarpe.HEADS_REFUSALS
    assert sorted(texts) == [1, 2, 3, 4]
    assert len(set(texts.values())) == len(texts) and all(texts.values())
    assert "128" in texts[1] and "256" in texts[2] and "8 heads" in texts[2] and "shared memory" in texts[3]


@pytest.mark.parametrize("misalign,match", [("q", "the heads bf16 kernel copies 16-byte chunks"),
                                            ("ld_kv", "the heads bf16 kernel copies k and v rows")])
def test_validate_raises_for_misaligned_operands_on_the_heads_route(misalign, match, monkeypatch):
    """At a shape the heads kernel takes, an operand off a 16-byte boundary or k/v rows 8 bytes off a multiple
    of 16 bytes apart raise, naming the route (it follows from the shape, not from the addresses)."""
    t = _bf16_attn_scaled(misalign)
    assert t["q"].data_ptr() % 16 if misalign == "q" else t["k"].stride(2) == 2 * 256 + 4
    _fake_routes(monkeypatch, [3], [1], heads=[0])
    with pytest.raises(ValueError, match=match):
        _validate_attn(t, 8)


def test_a_heads_launch_counts_on_the_heads_route(monkeypatch):
    """`_launch` counts a launch that `_validate` routes to the heads kernel once in `LAUNCHES` and once under
    `ROUTE_LAUNCHES["knarpe_attention/heads"]`, nothing on another route (the built library and the card
    faked: the C entry point records its call and returns 0)."""
    calls = []
    monkeypatch.setattr(knarpe, "load_library", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(knarpe, "_validate", lambda *a, **kw: (1, 3, 32, 256, 256, 0, 512, "heads"))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(knarpe, "LAUNCHES", dict(knarpe.LAUNCHES))  # this test's counts stay its own
    monkeypatch.setattr(knarpe, "ROUTE_LAUNCHES", dict(knarpe.ROUTE_LAUNCHES))
    t = _bf16_attn_scaled()
    before, launches = dict(knarpe.ROUTE_LAUNCHES), dict(knarpe.LAUNCHES)
    out = knarpe._launch("knarpe_attention", t["q"], t["k"], t["v"], None, t["rpe"], t["invalid"], None,
                         t["w_rpe"], t["b_rpe"], 8)
    assert out.shape == (1, 3, 256) and len(calls) == 1 and calls[0][:2] == (0, 1)
    assert knarpe.LAUNCHES == {**launches, "knarpe_attention": launches["knarpe_attention"] + 1}
    assert knarpe.ROUTE_LAUNCHES == {**before, "knarpe_attention/heads": before["knarpe_attention/heads"] + 1}
