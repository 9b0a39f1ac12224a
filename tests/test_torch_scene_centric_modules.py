"""PyTorch port: the scene-centric model's modules (`pairwise_relative=False`) and the last transformer and pooling
options against the JAX package, on the CPU.

  - `get_rel_dist` equal to JAX's bit for bit (the root in float64, correctly rounded as XLA's);
  - `tgt_rep` (K-futures token dedup): the gathers and the lazy KNN over the unique scenarios equal to the same calls
    over K replicas, bit for bit;
  - `seq_pooling` in the modes `first`, `last` and `mean_valid` to 1e-6 (an all-invalid row zeroed); an unknown
    mode raises;
  - the FFN's `gelu` (flax's tanh approximation, not torch's exact default) and `elu`, alone and in two-layer blocks;
  - the attention branches without RPE (`d_rpe = -1`), each also with `attn_dropout_weights` (deterministic: the
    JAX module with `deterministic=True`); the blocks' scene-centric branch, KNN cross-attention without RPE, 1e-4
    (`tests/test_torch_models.py`'s); the block inputs no model call site gives (a decoder self-attention without
    KNN indices, dense cross targets, targets of a self-attention) raise;
  - `attn_dropout_weights` drawing its masks: the port's attention against its own plain formula with the mask
    injected, in each layout that draws one (dense, KNN, dense-KNN, full-width KNN cross, hoisted K/V), to 1e-5;
    the per-step recompute (`torch.utils.checkpoint`) replays the masks (gradients bit-equal); no kernel wrapper is
    called with use_pallas;
  - the model methods (map encoding, TL tokens and a TL step, both latents, navi prediction, a policy step) of the
    scene-centric model with lane and stop-line TL tokens and the dest, goal and cmd navi, gain-0.5 weights, 2e-4;
  - every leaf of JAX's scene-centric flagship tree finds its port parameter (HPTR and RNN), with the widths the
    scene-centric model gives: pose embeddings into the stop lines' and the RNN's input encoders, no navi `mlp_pe`,
    no RPE projection anywhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, random_tree, set_threads, t2n, \
    to_jnp
from trafficbotsv15_tpu.config import leaderboard_config
from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.models.transformer import AttentionRPE as JAttn, TransformerBlock as JBlock
from trafficbotsv15_tpu.ops import pooling as jpool
from trafficbotsv15_tpu.ops import rpe as jrpe
from trafficbotsv15_tpu_torch.config import TransformerCfg
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre
from trafficbotsv15_tpu_torch.models.transformer import ACTIVATIONS, AttentionRPE, TransformerBlock
from trafficbotsv15_tpu_torch.ops import dropout as pdrop
from trafficbotsv15_tpu_torch.ops import pooling as ppool
from trafficbotsv15_tpu_torch.ops import rpe as prpe
from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params, params_from_jax

set_threads()
D, H = 32, 4
RNG = np.random.default_rng(22)
T, J = torch.from_numpy, jnp.asarray


def _f32(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def _close(port, ref, atol):
    np.testing.assert_allclose(t2n(port), np.asarray(ref, dtype=np.float32), rtol=0, atol=atol)


def _carry(jax_module, init_fn, port_module, seed=1):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), method=init_fn))
    tree = random_tree(shapes, seed)["params"]
    port_module.load_state_dict(params_from_jax(tree), strict=True)
    return {"params": to_jnp(tree)}


def _knn_idx(n_b, n, k):
    """Distinct nearest-neighbour indices of random positions, and the slots past 80 m invalid."""
    xy = _f32(n_b, n, 2, scale=50.0)
    inv = RNG.uniform(size=(n_b, n)) < 0.2
    dist = np.asarray(jrpe.get_rel_dist(J(xy), J(inv)))
    idx = np.argsort(dist, axis=-1, kind="stable")[..., :k].astype(np.int64)
    return idx, np.take_along_axis(dist, idx, -1) > 80.0


# ---------------------------------------------------------------------------------------------------- ops

def test_get_rel_dist_matches_jax_bit_for_bit():
    xy, xy2 = _f32(3, 17, 2, scale=300.0), _f32(3, 45, 2, scale=300.0)
    inv, inv2 = RNG.uniform(size=(3, 17)) < 0.2, RNG.uniform(size=(3, 45)) < 0.2
    for args in ((xy, inv), (xy, inv, xy2, inv2)):
        want = np.asarray(jrpe.get_rel_dist(*map(J, args)))
        got = prpe.get_rel_dist(*map(T, args))
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.isinf(want[np.broadcast_to(args[1][:, :, None], want.shape)]).all()


@pytest.mark.parametrize("rep", [1, 3])
def test_tgt_rep_reads_the_unique_scenarios(rep):
    """gather_tgt and get_tgt_knn_lazy over unique targets [n_u, ...] with tgt_rep equal the calls over the targets
    repeated to the sources' rows, bit for bit."""
    n_u, n_src, n_tgt, k = 2, 7, 40, 6
    feat = torch.from_numpy(_f32(n_u, n_tgt, 5))
    tgt_pose = torch.from_numpy(np.concatenate([_f32(n_u, n_tgt, 2, scale=40.0), _f32(n_u, n_tgt, 1)], -1))
    tgt_inv = torch.from_numpy(RNG.uniform(size=(n_u, n_tgt)) < 0.2)
    src_pose = torch.from_numpy(np.concatenate([_f32(n_u * rep, n_src, 2, scale=40.0), _f32(n_u * rep, n_src, 1)], -1))
    src_inv = torch.from_numpy(RNG.uniform(size=(n_u * rep, n_src)) < 0.2)
    full = lambda x: torch.repeat_interleave(x, rep, 0)  # noqa: E731
    idx, inv, rpe = prpe.get_tgt_knn_lazy(src_pose, src_inv, tgt_pose, tgt_inv, k, 30.0, tgt_rep=rep)
    idx_f, inv_f, rpe_f = prpe.get_tgt_knn_lazy(src_pose, src_inv, full(tgt_pose), full(tgt_inv), k, 30.0)
    assert torch.equal(idx, idx_f) and torch.equal(inv, inv_f) and torch.equal(rpe, rpe_f)
    assert torch.equal(prpe.gather_tgt(feat, idx, rep), prpe.gather_tgt(full(feat), idx))
    with pytest.raises(ValueError, match="unique scenarios"):
        prpe.gather_tgt(feat, idx[:1], 2)


@pytest.mark.parametrize("mode", ["first", "last", "mean_valid"])
def test_seq_pooling_modes_match_jax(mode):
    x, inv = _f32(2, 5, 7, 8), RNG.uniform(size=(2, 5, 7)) < 0.4
    inv[0, 0] = True  # an all-invalid row is zeroed
    got = ppool.seq_pooling(T(x), T(inv), mode)
    _close(got, jpool.seq_pooling(J(x), J(inv), mode), 1e-6)
    assert torch.all(got[0, 0] == 0)


def test_seq_pooling_refuses_an_unknown_mode():
    with pytest.raises(NotImplementedError, match="median"):
        ppool.seq_pooling(torch.zeros(1, 1, 2, 3), torch.zeros(1, 1, 2, dtype=torch.bool), "median")


def test_gelu_is_flaxs_tanh_approximation():
    x = torch.linspace(-6, 6, 2001)  # float32 roundings of one formula: within 1e-6
    np.testing.assert_allclose(ACTIVATIONS["gelu"](x).numpy(), np.asarray(fnn.gelu(J(x.numpy()))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ACTIVATIONS["elu"](x).numpy(), np.asarray(fnn.elu(J(x.numpy()))), rtol=0, atol=1e-6)
    # torch's default gelu is the exact one: another function, up to ~5e-4 away
    assert float((torch.nn.functional.gelu(x) - ACTIVATIONS["gelu"](x)).abs().max()) > 1e-4


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="swish"):
        TransformerBlock(TransformerCfg(d_model=D, n_head=H, activation="swish"), 1, "enc_self_attn", d_rpe=-1)


# ---------------------------------------------------------------------------------------------------- attention

def _attn_inputs():
    n_b, n_src, k = 2, 12, 5
    idx, kinv = _knn_idx(n_b, n_src, k)
    kinv[0, 3] = True  # a source with no valid target gets a zero output
    return dict(src=_f32(n_b, n_src, D), idx=idx, kinv=kinv, rpe=_f32(n_b, n_src, k, D),
                tgt=_f32(n_b, n_src, k, D, scale=2.0), ln=(1 + _f32(D, scale=0.1), _f32(D, scale=0.1)),
                mask2d=RNG.uniform(size=(n_b, n_src)) < 0.3)


# case -> (dense_knn_max, d_rpe, jax fn, port fn): the scene-centric model's layouts (no RPE), and with RPE the
# layouts attn_dropout_weights meets in the pairwise model
ATTN_CASES = {
    "dense_knn_no_rpe": (128, -1, lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"]),
                         lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"])),
    "project_then_gather_no_rpe": (4, -1, lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"]),
                                   lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"])),
    "cross_no_rpe_ln_fold": (128, -1,
                             lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"], tgt_ln=x["ln"]),
                             lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"], tgt_ln=x["ln"])),
    "static_kv_no_rpe": (128, -1,
                         lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], kv_static=m(
                             None, x["tgt"], compute_static_kv=True, tgt_ln=x["ln"])),
                         lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"],
                                        kv_static=m.static_kv(x["tgt"], None, ln=x["ln"]))),
    "dense": (128, -1, lambda m, x: m(x["src"], tgt_padding_mask=x["mask2d"]),
              lambda m, x: m(x["src"], tgt_padding_mask=x["mask2d"])),
    "dense_knn_rpe": (128, D, lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"]),
                      lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"])),
    "project_then_gather_rpe": (4, D,
                                lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"]),
                                lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"])),
    "cross_rpe": (128, D, lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"], rpe=x["rpe"],
                                         tgt_ln=x["ln"]),
                  lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_ln=x["ln"])),
}


@pytest.mark.parametrize("wdrop", [False, True], ids=["", "attn_dropout_weights"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_branches_match_jax(case, wdrop, monkeypatch):
    """Deterministic (no dropout scope / deterministic=True): attn_dropout_weights at p = 0.1 changes nothing, and
    with use_pallas it still calls no kernel wrapper (JAX's gates)."""
    from torch_rnn_common import count_wrappers

    dense_knn_max, d_rpe, jfn, pfn = ATTN_CASES[case]
    x = _attn_inputs()
    kw = dict(dropout_p=0.1, attn_dropout_weights=wdrop)
    jm = JAttn(d_model=D, n_head=H, d_rpe=d_rpe, dense_knn_max=dense_knn_max, **kw)
    pm = AttentionRPE(D, H, d_rpe=d_rpe, dense_knn_max=dense_knn_max, use_pallas=wdrop, **kw)
    calls = count_wrappers(monkeypatch)
    jx = {k: (tuple(map(J, v)) if isinstance(v, tuple) else J(v)) for k, v in x.items()}
    px = {k: (tuple(map(T, v)) if isinstance(v, tuple) else T(v)) for k, v in x.items()}
    variables = _carry(jm, lambda m: jfn(m, jx), pm)
    with torch.no_grad():
        out = pfn(pm, px)
    _close(out, jm.apply(variables, method=lambda m: jfn(m, jx)), 1e-4)
    if case != "dense":
        assert torch.all(out[0, 3] == 0)
    assert not calls["knarpe_attention"] and not calls["knarpe_cross_attention"]
    if d_rpe < 0:
        assert not hasattr(pm, "rpe_proj_w")


def _block_case(mode, kind):
    """(JAX block, port block, jax fn, port fn) of a two-layer block on one of its scene-centric or option paths."""
    n_b, n_src, k, kd = 2, 10, 6, 4
    src, src_inv = _f32(n_b, n_src, D), RNG.uniform(size=(n_b, n_src)) < 0.2
    idx, kinv = _knn_idx(n_b, n_src, kd)
    tgt4, tinv4 = _f32(n_b, n_src, k, D, scale=2.0), RNG.uniform(size=(n_b, n_src, k)) < 0.3
    act = {"gelu": "gelu", "elu": "elu"}.get(kind, "relu")
    jb = JBlock(d_model=D, n_head=H, n_layer=2, mode=mode, d_rpe=-1, activation=act)
    pb = TransformerBlock(TransformerCfg(d_model=D, n_head=H, activation=act), 2, mode, d_rpe=-1)
    base = dict(src=src, src_padding_mask=src_inv)
    if mode == "enc_self_attn":
        kw = dict(base, tgt_idx=idx, tgt_padding_mask=kinv)
    else:
        kw = dict(base, tgt=tgt4, tgt_padding_mask=tinv4)
        if mode == "dec_cross_attn":
            kw.update(decoder_tgt_idx=idx, decoder_tgt_padding_mask=kinv)
    src_j = kw.pop("src")
    return (jb, pb, lambda m: m(J(src_j), **{k: J(v) for k, v in kw.items()}),
            lambda m: m(T(src_j), **{k: T(v) for k, v in kw.items()}))


@pytest.mark.parametrize("mode,kind", [
    ("enc_self_attn", "gelu"), ("dec_cross_attn", "gelu"), ("dec_cross_attn", "elu"),
    ("enc_cross_attn", "no_rpe"), ("dec_cross_attn", "no_rpe"),
])
def test_transformer_block_paths_match_jax(mode, kind):
    jb, pb, jfn, pfn = _block_case(mode, kind)
    variables = _carry(jb, jfn, pb)
    with torch.no_grad():
        out = pfn(pb)
    _close(out, jb.apply(variables, method=jfn), 1e-4)


@pytest.mark.parametrize("mode,tgt_shape", [
    ("dec_cross_attn", (1, 3, 4, D)),  # no decoder_tgt_idx
    ("enc_cross_attn", (1, 5, D)),  # dense cross targets
    ("dec_cross_attn", (1, 5, D)),
    ("enc_self_attn", (1, 5, D)),  # targets of a self-attention
])
def test_block_inputs_no_model_gives_raise(mode, tgt_shape):
    pb = TransformerBlock(TransformerCfg(d_model=D, n_head=H), 1, mode, d_rpe=-1)
    kw = {}
    if mode == "dec_cross_attn" and len(tgt_shape) == 3:  # past the decoder self-attention
        kw["decoder_tgt_idx"] = torch.zeros(1, 3, 2, dtype=torch.long)
    with pytest.raises(ValueError, match="no model call site"):
        pb(torch.zeros(1, 3, D), tgt=torch.zeros(tgt_shape), **kw)


# ---------------------------------------------------------------------------------------------------- weight dropout

P_DROP = 0.3


def _masked_softmax(logits, invalid):
    logits = torch.where(invalid, -1e9, logits)
    e = torch.where(invalid, 0.0, torch.exp(logits - logits.amax(-1, keepdim=True)))
    den = e.sum(-1, keepdim=True)
    return e / torch.where(den <= 0, 1.0, den), den[..., 0] <= 0


def _plain_wdrop(m: AttentionRPE, layout, x, gen):
    """The attention's plain formula with dropout on its softmax weights, the keep mask drawn from gen in the shape
    the layout draws it, kept weights scaled by 1 / (1 - p)."""
    src = x["src"]
    n_b, n_s, _ = src.shape
    dh = D // H
    q = (src @ m.q_proj.weight.T + m.q_proj.bias).reshape(n_b, n_s, H, dh)

    def drop(a):
        keep = torch.rand(a.shape, generator=gen) < 1 - P_DROP
        return torch.where(keep, a / (1 - P_DROP), 0.0)

    if layout == "dense":
        kv = src @ m.kv_w + m.kv_b
        k, v = (t.reshape(n_b, n_s, H, dh) for t in kv.chunk(2, -1))
        invalid = x["mask2d"][:, None, None, :].expand(n_b, H, n_s, n_s)
        attn, _ = _masked_softmax(torch.einsum("bshd,bthd->bhst", q, k) / dh ** 0.5, invalid)
        out = torch.einsum("bhst,bthd->bshd", drop(attn), v).reshape(n_b, n_s, D)
        return out @ m.out_proj.weight.T + m.out_proj.bias
    if layout == "dense_knn":  # dense over the sources, masked to each one's KNN slots
        kv = src @ m.kv_w + m.kv_b
        k, v = (t.reshape(n_b, n_s, H, dh) for t in kv.chunk(2, -1))
        hit = torch.zeros(n_b, n_s, n_s).scatter_add_(2, x["idx"], (~x["kinv"]).float()) > 0
        attn, _ = _masked_softmax(torch.einsum("bshd,bthd->bsht", q, k) / dh ** 0.5, ~hit[:, :, None, :])
        out = torch.einsum("bsht,bthd->bshd", drop(attn), v).reshape(n_b, n_s, D)
    else:  # per-source K/V: gathered self-attention targets (with RPE) or the raw cross targets (no RPE)
        if layout == "knn":
            kv = prpe.gather_tgt(src @ m.kv_w + m.kv_b, x["idx"])
            rk, rv = (x["rpe"] @ m.rpe_proj_w + m.rpe_proj_b).chunk(2, -1)
            k, v = kv.chunk(2, -1)
            k, v = k + rk, v + rv
        else:
            k, v = (x["tgt"] @ m.kv_w + m.kv_b).chunk(2, -1)
        kk = k.shape[2]
        k, v = k.reshape(n_b, n_s, kk, H, dh), v.reshape(n_b, n_s, kk, H, dh)
        logits = (q[:, :, None] * k).sum(-1).transpose(2, 3) / dh ** 0.5
        attn, _ = _masked_softmax(logits, x["kinv"][:, :, None, :])
        out = torch.einsum("bshk,bskhd->bshd", drop(attn), v).reshape(n_b, n_s, D)
    out = out @ m.out_proj.weight.T + m.out_proj.bias
    return torch.where(x["kinv"].all(-1)[..., None], 0.0, out)


WDROP_LAYOUTS = {  # layout -> (dense_knn_max, d_rpe, call)
    "dense": (128, -1, lambda m, x: m(x["src"], tgt_padding_mask=x["mask2d"])),
    "dense_knn": (128, -1, lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"])),
    "knn": (4, D, lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"])),
    "cross": (128, -1, lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"])),
    "static_kv": (128, -1, lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"],
                                          kv_static=m.static_kv(x["tgt"], None))),
}


def _wdrop_module(layout, seed=5):
    dense_knn_max, d_rpe, call = WDROP_LAYOUTS[layout]
    m = AttentionRPE(D, H, d_rpe=d_rpe, dense_knn_max=dense_knn_max, use_pallas=True, dropout_p=P_DROP,
                     attn_dropout_weights=True)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    x = {k: (tuple(map(T, v)) if isinstance(v, tuple) else T(v)) for k, v in _attn_inputs().items()}
    return m, x, call


@pytest.mark.parametrize("layout", sorted(WDROP_LAYOUTS))
def test_attn_dropout_weights_is_the_plain_formula_with_its_mask(layout, monkeypatch):
    from torch_rnn_common import count_wrappers

    m, x, call = _wdrop_module(layout)
    calls = count_wrappers(monkeypatch)
    with torch.no_grad(), pdrop.dropout_scope(11, "cpu"):
        got = call(m, x)
    with torch.no_grad():
        want = _plain_wdrop(m, layout, x, torch.Generator().manual_seed(11))
        off = call(m, x)  # no scope: no mask
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert float((got - off).abs().max()) > 1e-3  # the mask did act
    assert not calls["knarpe_attention"] and not calls["knarpe_cross_attention"]


@pytest.mark.parametrize("layout", ["knn", "cross"])
def test_attn_dropout_weights_recompute_replays_the_mask(layout):
    """A step recomputed by torch.utils.checkpoint enters its scope again with its seed: the same masks, so the
    gradients equal the ones of the step kept in memory, bit for bit."""
    m, x, call = _wdrop_module(layout)
    src = x["src"].clone().requires_grad_(True)

    def step(s):
        with pdrop.dropout_scope(7, "cpu"):
            return call(m, dict(x, src=s)).square().sum()

    grads = []
    for use_ckpt in (False, True):
        m.zero_grad()
        s = src.detach().clone().requires_grad_(True)
        loss = torch.utils.checkpoint.checkpoint(step, s, use_reentrant=False) if use_ckpt else step(s)
        loss.backward()
        grads.append([s.grad.clone()] + [p.grad.clone() for p in m.parameters() if p.grad is not None])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------------------------------- model methods

def sc_cfg(navi_mode="dest", tl_mode="lane"):
    from torch_navi_common import navi_cfg

    cfg = navi_cfg(navi_mode)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pairwise_relative=False, tl_mode=tl_mode))


def _navi_params(dist):
    return {"logits": dist.logits} if hasattr(dist, "logits") else {"mean": dist.mean, "std": dist.std}


@pytest.mark.parametrize("navi_mode,tl_mode,n_mp", [("dest", "lane", 32), ("dest", "lane", 160), ("goal", "stop", 32),
                                                    ("cmd", "lane", 32)])
def test_scene_centric_model_methods_match_jax(navi_mode, tl_mode, n_mp):
    """encode_map (dense-KNN at 32 polylines, project-then-gather at 160), precompute_tl and step_tl, encode_latent
    (posterior and prior), predict_navi and one policy step, gain-0.5 weights."""
    cfg = sc_cfg(navi_mode, tl_mode)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    pmodel = port_model(cfg, tree)
    params = to_jnp(tree)
    batch = make_batch(dataclasses.replace(cfg.data, n_mp=n_mp), n_sc=2, seed=4)
    kw = dict(tl_mode=tl_mode, navi_mode=navi_mode, n_step_hist=cfg.n_step_hist)
    jpp = jax_pre({k: J(v) for k, v in batch.items()}, **kw)
    ppp = port_pre({k: T(v) for k, v in batch.items()}, **kw)

    def app(method, *a, **k):
        return jmodel.apply({"params": params}, *a, method=method, **k)

    with jax_sort_knn(), torch.no_grad():
        jmp = app("encode_map", jpp.mp_valid, jpp.mp_attr, jpp.mp_pose, jpp.mp_type)
        pmp = pmodel.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
        _close(pmp.feature, jmp.feature, 2e-4)
        jtl = app("precompute_tl", jpp.tl_valid, jpp.tl_attr, jpp.tl_pose, jmp)
        ptl = pmodel.precompute_tl(ppp.tl_valid, ppp.tl_attr, ppp.tl_pose, pmp)
        for f in ("knn_idx_tl2tl", "knn_invalid_tl2tl", "knn_invalid_tl2mp"):
            np.testing.assert_array_equal(t2n(getattr(ptl, f)), np.asarray(getattr(jtl, f)), err_msg=f)
        assert ptl.rpe_tl2tl is None and ptl.rpe_tl2mp is None and jtl.rpe_tl2mp is None
        _close(ptl.knn_tgt_tl2mp, jtl.knn_tgt_tl2mp, 2e-4)
        w = cfg.model.temp_window_size
        hist = np.asarray(jpp.tl_state, np.float32)[:, :, -w:]
        step_inv = np.zeros(w, bool)
        step_inv[:4] = True
        jf, jl = app("step_tl", J(hist), J(step_inv), jtl)
        pf, pl = pmodel.step_tl(T(hist), T(step_inv), ptl)
        _close(pf, jf, 2e-4)
        _close(pl, jl, 2e-4)
        for post in (True, False):
            jlat = app("encode_latent", jpp.ag_valid, jpp.ag_attr, jpp.ag_motion, jpp.ag_pose, jpp.ag_type,
                       jpp.tl_state.astype(jnp.float32), jmp, jtl, post)
            plat = pmodel.encode_latent(ppp.ag_valid, ppp.ag_attr, ppp.ag_motion, ppp.ag_pose, ppp.ag_type,
                                        ppp.tl_state.float(), pmp, ptl, posterior=post)
            _close(plat.mean, jlat.mean, 2e-4)
        jn = app("predict_navi", jpp.ag_valid, jpp.ag_attr, jpp.ag_motion, jpp.ag_pose, jpp.ag_type, jmp)
        pn = pmodel.predict_navi(ppp.ag_valid, ppp.ag_attr, ppp.ag_motion, ppp.ag_pose, ppp.ag_type, pmp)
        for key, val in _navi_params(jn).items():
            _close(_navi_params(pn)[key], val, 2e-4)

        n_sc, n_ag = ppp.ag_valid.shape[:2]
        lat = _f32(n_sc, n_ag, cfg.model.latent_encoder.latent_dim)
        if navi_mode == "dest":
            jnavi = pnavi = np.asarray(jnp.argmax(jn.logits, -1)).astype(np.int32)
        elif navi_mode == "cmd":
            pnavi = np.eye(jn.logits.shape[-1], dtype=bool)[np.asarray(jnp.argmax(jn.logits, -1))]
            jnavi = pnavi
        else:
            jnavi = pnavi = np.asarray(jn.mean, np.float32)
        hv = np.asarray(jpp.ag_valid).copy()
        hv[:, :, :3] = False
        valid_any = hv.any(-1)
        jd = app("step", ag_valid=J(hv[:, :, -1]), hist_ag_valid=J(hv), hist_ag_pose=jpp.ag_pose,
                 hist_ag_motion=jpp.ag_motion, hist_tl_state=None, hist_step_invalid=jnp.zeros(w, bool),
                 ag_attr=jpp.ag_attr, ag_type=jpp.ag_type, ag_latent=J(lat), ag_latent_valid=J(valid_any),
                 ag_navi=J(jnavi), ag_navi_valid=J(valid_any), tl_tokens=jtl, mp_tokens=jmp, tl_token_feature=jf)[0]
        pd = pmodel.step(T(hv[:, :, -1]), T(hv), ppp.ag_pose, ppp.ag_motion, ppp.ag_attr, ppp.ag_type, T(lat),
                         T(valid_any), T(pnavi), T(valid_any), ptl, pmp, pf)[0]
        _close(pd.mean, jd.mean, 2e-4)
        _close(pd.std, jd.std, 1e-6)


@pytest.mark.parametrize("arm", ["hptr_stop_goal", "rnn_lane_dest"])
def test_every_scene_centric_flagship_leaf_finds_its_parameter(arm):
    """leaderboard_config scene-centric (flax param shapes only): `load_jax_params` fills every port parameter from
    exactly one leaf, bit for bit; the stop lines' (HPTR) or the RNN agent encoder's input encoder reads a pose
    embedding; no attention has an RPE projection and the dest encoder no mlp_pe."""
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = leaderboard_config()
    m = dataclasses.replace(cfg.model, pairwise_relative=False)
    if arm == "hptr_stop_goal":
        m = dataclasses.replace(m, tl_mode="stop", navi_mode="goal")
    else:
        m = dataclasses.replace(m, temp_window_size=-1)
    cfg = dataclasses.replace(cfg, model=m)
    _, tree = jax_model_params(cfg, seed=0)
    model = build_model(port_cfg(cfg), device="cpu")
    load_jax_params(model, tree)
    state = params_from_jax(tree)
    assert len(state) == len(jax.tree_util.tree_leaves(tree)) == len(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert not any("rpe_proj" in k or "mlp_pe" in k for k in state)
    h = m.hidden_dim
    if arm == "hptr_stop_goal":
        from trafficbotsv15_tpu_torch.ops.pose_emb import pose_emb_out_dim

        assert model.tl_encoder.pe_cfg is not None  # the stop lines' pose embedding
        goal_pe = model.navi_encoder.goal_pe  # the map encoder's node pose embedding
        assert goal_pe.mode == m.mp_encoder.pose_emb.mode
        assert goal_pe.pe_dim == (h if m.mp_encoder.input_encoder.mode == "add" else h // 2)
        assert state["navi_encoder.mlp.fc0.weight"].shape[1] == pose_emb_out_dim(goal_pe) + 1  # ++ speed
    else:
        ie = model.ag_encoder.input_encoder
        assert model.ag_encoder.pe_cfg is not None and ie.mode == m.ag_encoder.input_encoder.mode


@pytest.mark.parametrize("navi_mode,tl_mode", [("dest", "lane"), ("goal", "stop")])
def test_reference_layout_round_trip(navi_mode, tl_mode):
    """No reference-torch golden holds the scene-centric model: its weights written in the reference's state_dict
    layout (`tests/torch_reference_layout.py`) load back through `utils/torch_import.py` strictly, bit for bit (no
    `linear_rpe` and no navi `mlp_pe` in the layout, the stop lines' input encoder at its scene-centric width)."""
    from torch_reference_layout import reference_state_dict
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from trafficbotsv15_tpu_torch.utils.torch_import import load_reference_state_dict

    cfg = port_cfg(sc_cfg(navi_mode, tl_mode))
    model = build_model(cfg, seed=3, device="cpu")
    sd = reference_state_dict(model, cfg.data)
    assert not any(".linear_rpe." in k or ".mlp_pe." in k for k in sd)
    back = build_model(cfg, seed=4, device="cpu")
    load_reference_state_dict(back, sd, cfg.model, cfg.time_step_gt)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
