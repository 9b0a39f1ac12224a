"""PyTorch port: the TrafficBots RNN family's modules (temp_window_size <= 0) against the JAX package.

Weights are random (numpy, fixed seed) in the flax tree's shapes, applied by
the JAX module and loaded into the port through `params_from_jax`; inputs
are numpy and shared; float32 on the CPU.
  - `MultiAgentGRU` alone (hidden 32, 3 layers, a third of the entries
    invalid), in step mode from a given hidden and in sequence mode from
    zeros: outputs and hiddens to 1e-5 (a few float32 roundings per gate);
  - the whole tiny RNN model (`tiny_config` with `temp_window_size=0`), with
    use_pallas False and True (True at dense_knn_max 4, so that the map and
    the agent self-attentions take B4's wrapper and the agent cross-
    attentions B2's; on the CPU their plain versions): the map tokens, the
    RNN TL encoder's tokens, four `step`s with the TL encoder, the GRU TL
    state predictor and both hiddens carried (action mean and std, TL logits,
    both hiddens), the flattened posterior latent encoder and the GRU navi
    predictor, each to 2e-4 (whole encoders, several blocks deep; the
    tolerance of `tests/test_torch_models.py`). The JAX package selects KNN
    targets by its stable sort, as the port does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_model_params, jax_sort_knn, port_model, random_tree, t2n, to_jnp
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.models.gru import MultiAgentGRU as JGRU
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre
from trafficbotsv15_tpu_torch.models.gru import MultiAgentGRU
from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

torch.set_num_threads(2)
T = torch.from_numpy
GRU_ATOL, MODEL_ATOL = 1e-5, 2e-4
N_STEP = 4


def _close(port, ref, atol):
    np.testing.assert_allclose(t2n(port), np.asarray(ref, dtype=np.float32), rtol=0, atol=atol)


def rnn_config(use_pallas: bool):
    cfg = tiny_config()
    tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=use_pallas, dense_knn_max=4 if use_pallas else 128)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temp_window_size=0, tf_cfg=tf))


@pytest.mark.parametrize("mode", ["step", "sequence"])
def test_multi_agent_gru_matches_flax(mode):
    rng = np.random.default_rng(3)
    d, n_layer, n_sc, n_ag, n_step = 32, 3, 2, 5, 6
    jm, pm = JGRU(d, n_layer), MultiAgentGRU(24, d, n_layer)
    x = rng.standard_normal((n_sc, n_ag, n_step, 24)).astype(np.float32)
    inv = rng.uniform(size=(n_sc, n_ag, n_step)) < 0.3
    h = rng.standard_normal((n_layer, n_sc, n_ag, d)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :, 0]), jnp.asarray(inv[:, :, 0])))
    tree = random_tree(shapes, seed=1)["params"]
    pm.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        if mode == "step":
            jy, jh = jm.apply({"params": to_jnp(tree)}, jnp.asarray(x[:, :, 0]), jnp.asarray(inv[:, :, 0]),
                              jnp.asarray(h))
            py, ph = pm(T(x[:, :, 0]), T(inv[:, :, 0]), T(h))
            _close(ph, jh, GRU_ATOL)
            assert not ph[:, torch.from_numpy(inv[:, :, 0])].any()  # invalid agents carry no state
        else:
            jy, _ = jm.apply({"params": to_jnp(tree)}, jnp.asarray(x), jnp.asarray(inv))
            py, ph = pm(T(x), T(inv))
            assert ph is None
        _close(py, jy, GRU_ATOL)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "pallas"])
def rnn_outputs(request):
    """Every compared output of both packages: {name: (port, jax)}."""
    cfg = rnn_config(request.param)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    params = to_jnp(tree)
    pmodel = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=4)
    jpp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True)
    ppp = port_pre({k: T(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True)
    out = {}

    jitted = {}

    def app(method, *a, **kw):  # jitted per method: one compile, not one per eager op
        if method not in jitted:
            static = {"posterior": True} if method == "encode_latent" else {}
            jitted[method] = jax.jit(lambda p, *a, **kw: jmodel.apply({"params": p}, *a, method=method, **static,
                                                                      **kw))
        return jitted[method](params, *a, **kw)

    with jax_sort_knn(), torch.no_grad():
        jmp = app("encode_map", jpp.mp_valid, jpp.mp_attr, jpp.mp_pose, jpp.mp_type)
        pmp = pmodel.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
        out["mp_feature"] = (pmp.feature, jmp.feature)
        jtl = app("precompute_tl", jpp.tl_valid, jpp.tl_attr, jpp.tl_pose, jmp)
        ptl = pmodel.precompute_tl(ppp.tl_valid, ppp.tl_attr, ppp.tl_pose, pmp)
        out["tl_attr"] = (ptl.attr, jtl.attr)

        n_sc, n_ag = ppp.ag_valid.shape[:2]
        rng = np.random.default_rng(5)
        lat = rng.standard_normal((n_sc, n_ag, cfg.model.latent_encoder.latent_dim)).astype(np.float32)
        valid_any = np.array(jpp.ag_valid).any(-1)
        jn = app("predict_navi", jpp.ag_valid, jpp.ag_attr, jpp.ag_motion, jpp.ag_pose, jpp.ag_type, jmp)
        pn = pmodel.predict_navi(ppp.ag_valid, ppp.ag_attr, ppp.ag_motion, ppp.ag_pose, ppp.ag_type, pmp)
        out["navi_logits"] = (pn.logits, jn.logits)
        navi = np.asarray(jnp.argmax(jn.logits, -1)).astype(np.int64)
        ph = pth = None
        jh = jnp.zeros((cfg.model.mp_encoder.pl_encoder.n_layer, n_sc, n_ag, cfg.model.hidden_dim))
        jth = jnp.zeros((cfg.model.tl_state_predictor.n_layer,) + tuple(jpp.tl_valid.shape) + (cfg.model.hidden_dim,))
        for t in range(N_STEP):
            hv = np.array(jpp.ag_valid[:, :, t:t + 1])
            pose, motion = np.array(jpp.ag_pose[:, :, t:t + 1]), np.array(jpp.ag_motion[:, :, t:t + 1])
            tl_state = np.array(jpp.tl_state[:, :, t:t + 1], np.float32)
            jd, jl, jh, jth = app(
                "step", ag_valid=jnp.asarray(hv[:, :, -1]), hist_ag_valid=jnp.asarray(hv),
                hist_ag_pose=jnp.asarray(pose), hist_ag_motion=jnp.asarray(motion),
                hist_tl_state=jnp.asarray(tl_state), hist_step_invalid=jnp.zeros(1, bool), ag_attr=jpp.ag_attr,
                ag_type=jpp.ag_type, ag_latent=jnp.asarray(lat), ag_latent_valid=jnp.asarray(valid_any),
                ag_navi=jnp.asarray(navi), ag_navi_valid=jnp.asarray(valid_any), tl_tokens=jtl, mp_tokens=jmp,
                rnn_hidden=jh, tl_rnn_hidden=jth)
            pd, pl, ph, pth = pmodel.step(
                T(hv[:, :, -1]), T(hv), T(pose), T(motion), ppp.ag_attr, ppp.ag_type, T(lat), T(valid_any),
                T(navi), T(valid_any), ptl, pmp, hist_tl_state=T(tl_state),
                hist_step_invalid=torch.zeros(1, dtype=torch.bool), rnn_hidden=ph, tl_rnn_hidden=pth)
        out.update(action_mean=(pd.mean, jd.mean), action_std=(pd.std, jd.std), tl_logits=(pl, jl),
                   rnn_hidden=(ph, jh), tl_rnn_hidden=(pth, jth))
        gt_tl = jpp.gt_tl_state.astype(jnp.float32)
        jlat = app("encode_latent", jpp.gt_valid, jpp.ag_attr, jpp.gt_motion, jpp.gt_pose, jpp.ag_type, gt_tl,
                   jmp, jtl)
        plat = pmodel.encode_latent(ppp.gt_valid, ppp.ag_attr, ppp.gt_motion, ppp.gt_pose, ppp.ag_type,
                                    ppp.gt_tl_state.float(), pmp, ptl, posterior=True)
        out.update(latent_post_mean=(plat.mean, jlat.mean), latent_post_std=(plat.std, jlat.std))
        # the RNN TL encoder of the latent posterior reads every step
        jtlf = jmodel.apply({"params": params}, gt_tl, jtl, None, True,
                            method=lambda m, *a: m.latent_encoder.tl_encoder_post(*a))
        ptlf = pmodel.latent_encoder.tl_encoder_post(ppp.gt_tl_state.float(), ptl, called_by_latent_encoder=True)
        out["latent_tl_feature"] = (ptlf, jtlf)
    return out


@pytest.mark.parametrize("name", ["mp_feature", "tl_attr", "navi_logits", "action_mean", "action_std", "tl_logits",
                                  "rnn_hidden", "tl_rnn_hidden", "latent_post_mean", "latent_post_std",
                                  "latent_tl_feature"])
def test_rnn_model_outputs_match_jax(rnn_outputs, name):
    port, ref = rnn_outputs[name]
    assert tuple(port.shape) == tuple(ref.shape)
    _close(port, ref, MODEL_ATOL)
