"""PyTorch port: model modules against the JAX package with carried weights.

Weights are random (numpy, fixed seed) in the flax tree's shapes, applied by
the JAX module and loaded into the port through `params_from_jax`. Inputs
are numpy and shared. float32 on the CPU; tolerances are absolute on
outputs of O(1-10): 1e-4 for single attention modules and blocks
(reassociated float32 sums), 2e-4 for whole encoders (several blocks deep).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, random_tree, t2n, to_jnp
from trafficbotsv15_tpu.config import leaderboard_config, tiny_config
from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.models.transformer import AttentionRPE as JAttn, TransformerBlock as JBlock
from trafficbotsv15_tpu.ops.rpe import get_rel_pose
from trafficbotsv15_tpu_torch.config import TransformerCfg
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre
from trafficbotsv15_tpu_torch.models.transformer import AttentionRPE, TransformerBlock
from trafficbotsv15_tpu_torch.train.pipeline import build_model
from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params, params_from_jax

torch.set_num_threads(2)
D, H = 32, 4
RNG = np.random.default_rng(0)
T = torch.from_numpy


def _close(port, ref, atol):
    np.testing.assert_allclose(t2n(port), np.asarray(ref, dtype=np.float32), rtol=0, atol=atol)


def _f32(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def _knn_idx(n_b, n, k):
    """Distinct KNN indices of random poses (the selection a block receives)."""
    pose = np.concatenate([_f32(n_b, n, 2, scale=50.0), _f32(n_b, n, 1)], -1)
    inv = RNG.uniform(size=(n_b, n)) < 0.2
    _, dist = get_rel_pose(jnp.asarray(pose), jnp.asarray(inv))
    idx = np.argsort(np.asarray(dist), axis=-1, kind="stable")[..., :k].astype(np.int64)
    return idx, np.take_along_axis(np.asarray(dist), idx, -1) > 80.0


def _carry(jax_module, init_fn, port_module, seed=1):
    """Random flax params for jax_module (through init_fn) loaded into port_module."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), method=init_fn))
    tree = random_tree(shapes, seed)["params"]
    port_module.load_state_dict(params_from_jax(tree), strict=True)
    return {"params": to_jnp(tree)}


def _attn_inputs():
    n_b, n_src, k = 2, 12, 5
    idx, kinv = _knn_idx(n_b, n_src, k)
    return dict(src=_f32(n_b, n_src, D), idx=idx, kinv=kinv, rpe=_f32(n_b, n_src, k, D),
                tgt=_f32(n_b, n_src, k, D, scale=2.0), ln=(1 + _f32(D, scale=0.1), _f32(D, scale=0.1)),
                mask2d=RNG.uniform(size=(n_b, n_src)) < 0.3)


# case -> (dense_knn_max, d_rpe, jax fn(module, x), port fn(module, x))
ATTN_CASES = {
    "dense_knn": (128, D,
                  lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"]),
                  lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"])),
    "project_then_gather": (4, D,
                            lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"]),
                            lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], rpe=x["rpe"], tgt_idx=x["idx"])),
    "dense_knn_static_rpe": (
        128, D,
        lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"],
                       rpe_kv_static=m(None, None, rpe=x["rpe"], compute_static_kv=True)),
        lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], tgt_idx=x["idx"],
                       rpe_kv_static=m.static_rpe_kv(x["rpe"]))),
    "fused_kv_rpe_ln_fold": (128, D,
                             lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"], rpe=x["rpe"],
                                            tgt_ln=x["ln"]),
                             lambda m, x: m(x["src"], x["tgt"], tgt_padding_mask=x["kinv"], rpe=x["rpe"],
                                            tgt_ln=x["ln"])),
    "static_kv": (128, D,
                  lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"], kv_static=m(
                      None, x["tgt"], rpe=x["rpe"], compute_static_kv=True, tgt_ln=x["ln"])),
                  lambda m, x: m(x["src"], tgt_padding_mask=x["kinv"],
                                 kv_static=m.static_kv(x["tgt"], x["rpe"], ln=x["ln"]))),
    "dense": (128, -1,
              lambda m, x: m(x["src"], tgt_padding_mask=x["mask2d"]),
              lambda m, x: m(x["src"], tgt_padding_mask=x["mask2d"])),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_rpe_branches(case):
    dense_knn_max, d_rpe, jfn, pfn = ATTN_CASES[case]
    x = _attn_inputs()
    x["kinv"][0, 3] = True  # a source with no valid target gets a zero output
    jm = JAttn(d_model=D, n_head=H, d_rpe=d_rpe, dense_knn_max=dense_knn_max)
    pm = AttentionRPE(D, H, d_rpe=d_rpe, dense_knn_max=dense_knn_max)
    jx = {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)) for k, v in x.items()}
    px = {k: (tuple(map(T, v)) if isinstance(v, tuple) else T(v)) for k, v in x.items()}
    variables = _carry(jm, lambda m: jfn(m, jx), pm)
    with torch.no_grad():
        out = pfn(pm, px)
    _close(out, jm.apply(variables, method=lambda m: jfn(m, jx)), 1e-4)
    if case != "dense":
        assert torch.all(out[0, 3] == 0)


@pytest.mark.parametrize("mode,dense_knn_max,static", [
    ("dec_cross_attn", 128, False),  # the agent encoder's block
    ("dec_cross_attn", 128, True),  # the TL encoder's block (static K/V of the map targets)
    ("enc_self_attn", 128, False),  # the map encoder's block, dense-KNN
    ("enc_self_attn", 4, False),  # the map encoder's block, project-then-gather
])
def test_transformer_block(mode, dense_knn_max, static):
    n_b, n_src, k, kd = 2, 10, 6, 4
    src, src_inv = _f32(n_b, n_src, D), RNG.uniform(size=(n_b, n_src)) < 0.2
    idx, kinv = _knn_idx(n_b, n_src, kd)
    rpe_d = _f32(n_b, n_src, kd, D)
    tgt, tinv, rpe = _f32(n_b, n_src, k, D, scale=2.0), RNG.uniform(size=(n_b, n_src, k)) < 0.3, _f32(n_b, n_src, k, D)
    jb = JBlock(d_model=D, n_head=H, n_layer=2, mode=mode, d_rpe=D, dense_knn_max=dense_knn_max)
    pb = TransformerBlock(TransformerCfg(d_model=D, n_head=H, dense_knn_max=dense_knn_max), 2, mode, d_rpe=D)
    J = jnp.asarray
    if mode == "enc_self_attn":
        def jfn(m):
            return m(J(src), src_padding_mask=J(src_inv), tgt_idx=J(idx), tgt_padding_mask=J(kinv), rpe=J(rpe_d))

        def pfn(m):
            return m(T(src), src_padding_mask=T(src_inv), tgt_idx=T(idx), tgt_padding_mask=T(kinv), rpe=T(rpe_d))
    elif static:
        def jfn(m):
            skv = m(None, tgt=J(tgt), rpe=J(rpe), decoder_rpe=J(rpe_d), compute_static_kv=True)
            return m(J(src), src_padding_mask=J(src_inv), tgt_padding_mask=J(tinv), decoder_tgt_idx=J(idx),
                     decoder_tgt_padding_mask=J(kinv), static_kv=skv)

        def pfn(m):
            skv = m.compute_static_kv(tgt=T(tgt), rpe=T(rpe), decoder_rpe=T(rpe_d))
            return m(T(src), src_padding_mask=T(src_inv), tgt_padding_mask=T(tinv), decoder_tgt_idx=T(idx),
                     decoder_tgt_padding_mask=T(kinv), static_kv=skv)
    else:
        def jfn(m):
            return m(J(src), src_padding_mask=J(src_inv), tgt=J(tgt), tgt_padding_mask=J(tinv), rpe=J(rpe),
                     decoder_tgt_idx=J(idx), decoder_tgt_padding_mask=J(kinv), decoder_rpe=J(rpe_d))

        def pfn(m):
            return m(T(src), src_padding_mask=T(src_inv), tgt=T(tgt), tgt_padding_mask=T(tinv), rpe=T(rpe),
                     decoder_tgt_idx=T(idx), decoder_tgt_padding_mask=T(kinv), decoder_rpe=T(rpe_d))
    variables = _carry(jb, jfn, pb)
    with torch.no_grad():
        out = pfn(pb)
    _close(out, jb.apply(variables, method=jfn), 1e-4)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    jmodel, tree = jax_model_params(cfg, seed=0)
    pmodel = port_model(cfg, tree)  # raises unless every leaf, the posterior encoders' too, fills a parameter
    return cfg, jmodel, to_jnp(tree), pmodel


def _inputs(cfg, n_mp):
    batch = make_batch(cfg.data.__class__(**{**cfg.data.__dict__, "n_mp": n_mp}), n_sc=2, seed=4)
    jpp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist)
    ppp = port_pre({k: T(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist)
    return jpp, ppp


@pytest.mark.parametrize("n_mp", [32, 160])  # map self-attention dense-KNN / project-then-gather
def test_traffic_bots_methods(tiny, n_mp):
    cfg, jmodel, params, pmodel = tiny
    jpp, ppp = _inputs(cfg, n_mp)

    def app(method, *a, **kw):
        return jmodel.apply({"params": params}, *a, method=method, **kw)

    with jax_sort_knn(), torch.no_grad():
        jmp = app("encode_map", jpp.mp_valid, jpp.mp_attr, jpp.mp_pose, jpp.mp_type)
        pmp = pmodel.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
        _close(pmp.feature, jmp.feature, 2e-4)

        jtl = app("precompute_tl", jpp.tl_valid, jpp.tl_attr, jpp.tl_pose, jmp)
        ptl = pmodel.precompute_tl(ppp.tl_valid, ppp.tl_attr, ppp.tl_pose, pmp)
        np.testing.assert_array_equal(ptl.knn_idx_tl2tl.numpy(), np.asarray(jtl.knn_idx_tl2tl))
        for f in ("attr", "knn_tgt_tl2mp", "rpe_tl2mp", "rpe_tl2tl"):
            _close(getattr(ptl, f), getattr(jtl, f), 2e-4)

        w = cfg.model.temp_window_size
        hist = np.asarray(jpp.tl_state, np.float32)[:, :, -w:]
        step_inv = np.zeros(w, bool)
        step_inv[:4] = True  # an early step: the first slots are still empty
        jf, jl = app("step_tl", jnp.asarray(hist), jnp.asarray(step_inv), jtl)
        pf, pl = pmodel.step_tl(T(hist), T(step_inv), ptl)
        _close(pf, jf, 2e-4)
        _close(pl, jl, 2e-4)

        jn = app("predict_navi", jpp.ag_valid, jpp.ag_attr, jpp.ag_motion, jpp.ag_pose, jpp.ag_type, jmp)
        pn = pmodel.predict_navi(ppp.ag_valid, ppp.ag_attr, ppp.ag_motion, ppp.ag_pose, ppp.ag_type, pmp)
        _close(pn.logits, jn.logits, 2e-4)

        n_sc, n_ag = ppp.ag_valid.shape[:2]
        lat = _f32(n_sc, n_ag, cfg.model.latent_encoder.latent_dim)
        navi = np.asarray(jnp.argmax(jn.logits, -1)).astype(np.int32)
        hv = np.asarray(jpp.ag_valid).copy()
        hv[:, :, :3] = False  # a partly filled history window
        valid_any = hv.any(-1)
        jd, _, _, _ = app(
            "step", ag_valid=jnp.asarray(hv[:, :, -1]), hist_ag_valid=jnp.asarray(hv), hist_ag_pose=jpp.ag_pose,
            hist_ag_motion=jpp.ag_motion, hist_tl_state=None, hist_step_invalid=jnp.zeros(w, bool),
            ag_attr=jpp.ag_attr, ag_type=jpp.ag_type, ag_latent=jnp.asarray(lat),
            ag_latent_valid=jnp.asarray(valid_any), ag_navi=jnp.asarray(navi), ag_navi_valid=jnp.asarray(valid_any),
            tl_tokens=jtl, mp_tokens=jmp, tl_token_feature=jf)
        pd = pmodel.step(T(hv[:, :, -1]), T(hv), ppp.ag_pose, ppp.ag_motion, ppp.ag_attr, ppp.ag_type, T(lat),
                         T(valid_any), T(navi), T(valid_any), ptl, pmp, pf)
        _close(pd.mean, jd.mean, 2e-4)
        _close(pd.std, jd.std, 1e-6)


def test_flagship_weight_carry_round_trip():
    """Every port parameter of the flagship model is filled from the flax tree
    with its shape, and every flax leaf fills one (the posterior latent encoders
    included); a leaf with no parameter raises."""
    cfg = leaderboard_config()
    _, tree = jax_model_params(cfg, seed=0)
    model = build_model(port_cfg(cfg), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_jax_params(model, tree)
    state = params_from_jax(tree)
    assert set(state) == set(before)
    for k, v in model.state_dict().items():
        assert v.shape == before[k].shape == state[k].shape, k
        assert torch.equal(v, state[k]), k
    assert len(state) == len(jax.tree_util.tree_leaves(tree))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(model, {**tree, "no_such_module": {"kernel": np.zeros((2, 2), np.float32)}})
    assert sum(v.numel() for v in state.values()) > 5_000_000  # the flagship's ~10M-parameter policy
