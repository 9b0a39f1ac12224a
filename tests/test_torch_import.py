"""PyTorch port: its reference-weight importer against the JAX package's.

For every model golden whose weights the port maps (`tests/test_torch_golden_model.py`'s
cases and `traffic_bots_full`), the port's `utils/torch_import.py` result, as
the golden tests load it, must equal the JAX package's route key for key and
bit for bit: JAX `utils/torch_import.py::map_*` -> `conform` against the flax
param structure (`jax.eval_shape` of the module's init on the golden's
inputs: shapes only, no compute) -> the port's `utils/jax_import.py::params_from_jax`.
Also `load_reference_state_dict`'s strictness: a missing or extra entry and a
transposed weight raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_golden_model as gm
from test_torch_helpers import set_threads
from trafficbotsv15_tpu.utils import torch_import as jti
from trafficbotsv15_tpu_torch import config as pc
from trafficbotsv15_tpu_torch.utils import torch_import as ti
from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

set_threads()
RNG = jax.random.PRNGKey(0)


def _flax_params(module, *args, method=None, **kwargs):
    """The flax param structure of `module` on these inputs, as numpy zeros (no compute)."""
    init = (lambda: module.init(RNG, *args, **kwargs)) if method is None else (
        lambda: module.init(RNG, *args, method=method, **kwargs))
    shapes = jax.eval_shape(init).get("params", {})  # a parameter-free module (std_cat) has none
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _j(ins):
    return {k: jnp.asarray(v) for k, v in ins.items()}


def _jax_block(meta, a, **fields):
    from trafficbotsv15_tpu.models.transformer import TransformerBlock

    m = TransformerBlock(d_model=meta["d_model"], n_head=meta["n_head"], n_layer=meta["n_layer"], mode=meta["mode"],
                         d_rpe=meta["d_rpe"], out_layernorm=meta["out_layernorm"])
    return m, (a["src"],), dict(src_padding_mask=a["src_pad"], **{k: a[v] for k, v in fields.items()})


def _jax_case(name):
    """(JAX-mapped tree, flax module, init args, init kwargs) of one model golden, as tests/test_model_parity.py
    builds them."""
    from trafficbotsv15_tpu import config as jc
    from trafficbotsv15_tpu.models import heads, latent_encoder, mlp, traffic_light, transformer

    sd, ins, _, meta = gm.load_golden("model", name)
    a = _j(ins)
    if name == "mlp_ln":
        return (jti.map_mlp(sd, "", 3, use_layernorm=True, dropout_p=0.1),
                mlp.MLP(fc_dims=meta["fc_dims"], dropout_p=meta["dropout_p"], use_layernorm=True),
                (a["x"], a["invalid"]), {})
    if name == "mlp_plain":
        return (jti.map_mlp(sd, "", 2, end_layer_activation=False),
                mlp.MLP(fc_dims=meta["fc_dims"], end_layer_activation=False), (a["x"],), {})
    if name.startswith("input_encoder_"):
        return ({"mlp": jti.map_mlp(sd, "mlp", 3, end_layer_activation=False)},
                mlp.InputEncoder(hidden_dim=64, pe_dim=meta["pe_dim"], n_layer=3, mode=meta["mode"]),
                (a["attr"], a["pe"]), {})
    if name == "polyline_encoder":
        return (jti.map_polyline_encoder(sd, "", 3, dropout_p=0.1),
                mlp.PolylineEncoder(hidden_dim=64, n_layer=3, pooling_mode="max_valid", mlp_dropout_p=0.1),
                (a["x"], a["invalid"]), {})
    if name.startswith("attn_"):
        m = transformer.AttentionRPE(d_model=meta["d_model"], n_head=meta["n_head"], dropout_p=0.1,
                                     d_rpe=meta.get("d_rpe", -1), apply_q_rpe=meta.get("apply_q_rpe", False))
        args = (a["src"],) + ((a["tgt"],) if "tgt" in a else ())
        kw = dict(tgt_padding_mask=a["pad"], **({"rpe": a["rpe"]} if "rpe" in a else {}))
        return jti.map_attention(sd, "", meta["d_model"], meta.get("apply_q_rpe", False)), m, args, kw
    if name.startswith("tfblock_"):
        fields = {
            "tfblock_enc_self_knn": dict(tgt_idx="idx", tgt_padding_mask="knn_pad", rpe="rpe"),
            "tfblock_enc_cross": dict(tgt="tgt", tgt_padding_mask="tgt_pad", rpe="rpe"),
            "tfblock_dec_cross": dict(tgt="tgt", tgt_padding_mask="tgt_pad", rpe="rpe", decoder_tgt_idx="dec_idx",
                                      decoder_tgt_padding_mask="dec_pad", decoder_rpe="dec_rpe"),
            "tfblock_dense_self": {},
        }[name]
        if "idx" in a:
            a["idx"] = a["idx"].astype(jnp.int32)
        if "dec_idx" in a:
            a["dec_idx"] = a["dec_idx"].astype(jnp.int32)
        m, args, kw = _jax_block(meta, a, **fields)
        return jti.map_transformer_block(sd, "", meta["d_model"], meta["n_layer"], meta["mode"]), m, args, kw
    if name.startswith("action_head_"):
        cfg = jc.ActionHeadCfg(log_std=meta["log_std"], n_layer=3, branch_type=meta["branch_type"],
                               mlp_use_layernorm=meta.get("mlp_use_layernorm", False))
        m = heads.ActionHead(cfg=cfg, hidden_dim=64, action_dim=2)
        return (jti.map_action_head(sd, "", 3, cfg.branch_type, cfg.mlp_use_layernorm, cfg.log_std is not None), m,
                (a["x"], a["valid"], a["ag_type"]), {})
    if name.startswith("add_navi_"):
        m = heads.AddNaviLatent(cfg=jc.AddNaviLatentCfg(mode=meta["mode"], res_add=meta["res_add"], n_layer=2,
                                                        mlp_dropout_p=0.1), hidden_dim=64)
        return jti.map_add_navi_latent(sd, "", 2, False, 0.1), m, (a["x"], a["z"], a["z_valid"]), {}
    if name.startswith("navi_pred_"):
        from trafficbotsv15_tpu.models.navigation import NaviPredictor
        from trafficbotsv15_tpu.models.tokens import MapTokens
        from trafficbotsv15_tpu.ops.pose_emb import PoseEmbConfig

        cfg, w = jc.NaviPredictorCfg(n_layer_tf=meta["n_layer_tf"], n_layer_mlp=meta["n_layer_mlp"]), \
            meta["temp_window_size"]
        m = NaviPredictor(cfg=cfg, ag_encoder_cfg=jc.AgEncoderCfg(), tf_cfg=jc.TransformerCfg(d_model=64),
                          hidden_dim=64, navi_mode=meta["navi_mode"], navi_dim=meta["navi_dim"],
                          pairwise_relative=True, temp_window_size=w, n_tgt_knn=32, dist_limit=500.0,
                          pose_rpe=PoseEmbConfig(mode="pe_xy_yaw", pe_dim=64, theta_xy=1e3, theta_cs=1e1))
        mp = MapTokens(invalid=a["mp_invalid"], feature=a["mp_feature"], pose=a["mp_pose"], type=a["mp_type"])
        mapped = jti.map_navi_predictor(sd, "", cfg, jc.AgEncoderCfg(), 64, w, jc.PolylineEncoderCfg(), 64,
                                        meta["navi_mode"])
        return mapped, m, (a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], mp), {}
    if name.startswith("dist_enc_diag_gaus"):
        branch = name.endswith("branch")
        cfg = jc.DistEncoderCfg(dist_type="diag_gaus", branch_type=branch, log_std=None if branch else 0.0, n_layer=3)
        m = latent_encoder.DistEncoder(cfg=cfg, hidden_dim=64, out_dim=16)
        return (jti.map_dist_encoder(sd, "", "diag_gaus", 3, branch, False, not branch), m,
                (a["x"], a["valid"], a["ag_type"]), {})
    if name.startswith(("dist_enc_cat", "dist_enc_std_cat")):
        branch, dist_type = name.endswith("branch"), meta["dist_type"]
        cfg = jc.DistEncoderCfg(dist_type=dist_type, branch_type=branch, n_cat=meta["n_cat"], log_std=None, n_layer=3)
        m = latent_encoder.DistEncoder(cfg=cfg, hidden_dim=64, out_dim=16)
        return (jti.map_dist_encoder(sd, "", dist_type, 3, branch, False, False), m,
                (a["x"], a["valid"], a["ag_type"]), {})
    if name == "tl_encoder_stacked":
        from trafficbotsv15_tpu.models.tokens import MapTokens
        from trafficbotsv15_tpu.ops.pose_emb import PoseEmbConfig

        cfg, w = jc.TlEncoderCfg(temp_stack_input=True, n_layer_tf=meta["n_layer_tf"]), meta["temp_window_size"]
        m = traffic_light.TrafficLightEncoder(
            cfg=cfg, tf_cfg=jc.TransformerCfg(d_model=64), hidden_dim=64, tl_state_dim=5, tl_mode="lane",
            pairwise_relative=True, temp_window_size=w, n_tgt_knn=32, dist_limit=500.0,
            pose_rpe=PoseEmbConfig(mode="pe_xy_yaw", pe_dim=64, theta_xy=1e3, theta_cs=1e1))
        mp = MapTokens(invalid=a["mp_invalid"], feature=a["mp_feature"], pose=a["mp_pose"],
                       type=jnp.ones(a["mp_invalid"].shape + (11,), bool))

        def fwd(mdl):
            return mdl(a["tl_state"], mdl.precompute(a["tl_valid"], a["tl_attr"].astype(jnp.int32), a["tl_pose"], mp))

        return jti.map_tl_encoder(sd, "", cfg, 64, w, jc.PolylineEncoderCfg()), m, (), dict(method=fwd)
    if name == "tl_predictor_hptr":
        m = traffic_light.TrafficLightStatePredictor(cfg=jc.TlStatePredictorCfg(n_layer=3), hidden_dim=64,
                                                     tl_state_dim=5, temp_window_size=11)
        return jti.map_tl_predictor(sd, "", 3, 64, 11), m, (a["x"], a["invalid"]), {}
    if name.startswith("gru_"):
        from trafficbotsv15_tpu.models.gru import MultiAgentGRU

        m = MultiAgentGRU(hidden_dim=meta["hidden"], n_layer=meta["n_layer"], dropout_p=0.1)
        return jti.map_gru(sd, "", meta["n_layer"], meta["hidden"]), m, (a["x"], a["invalid"]), {}
    raise KeyError(name)


def _jax_full():
    """(JAX-mapped tree, flax params of traffic_bots_full) with every phase traced once under eval_shape."""
    from trafficbotsv15_tpu import config as jc
    from trafficbotsv15_tpu.models.traffic_bots import TrafficBots

    sd, ins, _, meta = gm.load_golden("model", "traffic_bots_full")
    cfg = jc.ModelCfg(hidden_dim=64, tf_cfg=jc.TransformerCfg(d_model=64),
                      mp_encoder=jc.MapEncoderCfg(n_layer_tf=meta["n_layer_mp"]),
                      tl_encoder=jc.TlEncoderCfg(n_layer_tf=meta["n_layer_tl"]),
                      ag_encoder=jc.AgEncoderCfg(n_layer_tf=meta["n_layer_ag"]),
                      navi_predictor=jc.NaviPredictorCfg(n_layer_tf=meta["n_layer_navi"]))
    model = TrafficBots(cfg=cfg, time_step_gt=meta["time_step_gt"])
    w = int(meta["w"])
    a = _j({k: v for k, v in ins.items() if k != "w"})

    def init_all(mdl):
        mp = mdl.encode_map(a["mp_valid"], a["mp_attr"], a["mp_pose"], a["mp_type"])
        tl = mdl.precompute_tl(a["tl_valid"], a["tl_attr"], a["tl_pose"], mp)
        mdl.encode_latent(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], a["tl_state"], mp,
                          tl, posterior=True)
        mdl.predict_navi(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], mp)
        return mdl.step(a["ag_valid"][:, :, w - 1], a["ag_valid"][:, :, :w], a["ag_pose"][:, :, :w],
                        a["ag_motion"][:, :, :w], a["tl_state"][:, :, :w], jnp.zeros((w,), bool), a["ag_attr"],
                        a["ag_type"], a["ag_latent"], jnp.ones(a["ag_navi"].shape, bool), a["ag_navi"],
                        a["ag_navi_valid"], tl, mp)

    return jti.map_traffic_bots(sd, cfg, meta["time_step_gt"]), _flax_params(model, method=init_all)


def _port_state(case, monkeypatch):
    """The port's conformed mapping of a golden's weights, as its golden test loads them."""
    seen = []
    real = gm._loaded

    def recording(module, mapped, device):
        seen.append(ti.conform(mapped, module.state_dict()))
        return real(module, mapped, device)

    monkeypatch.setattr(gm, "_loaded", recording)
    gm.run_case(case)
    (state,) = seen
    return state


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k


MAPPED = sorted({name for name, _ in gm.MODEL_CASES})


@pytest.mark.parametrize("case", MAPPED)
def test_port_mapping_equals_the_jax_mapping(case, monkeypatch):
    mapped, module, args, kwargs = _jax_case(case)
    want = params_from_jax(jti.conform(mapped, _flax_params(module, *args, **kwargs)))
    _assert_bit_equal(_port_state(case, monkeypatch), want)


def test_port_mapping_equals_the_jax_mapping_for_the_whole_model():
    mapped, flax_params = _jax_full()
    want = params_from_jax(jti.conform(mapped, flax_params))
    sd, _, _, meta = gm.load_golden("model", "traffic_bots_full")
    model = gm.full_model("traffic_bots_full", "cpu")[0]  # through load_reference_state_dict
    _assert_bit_equal(model.state_dict(), want)
    _assert_bit_equal(ti.conform(ti.map_traffic_bots(sd, gm.full_model_cfg(meta), meta["time_step_gt"]),
                                 model.state_dict()), want)


def test_port_mapping_equals_the_jax_mapping_for_the_rnn_model():
    """traffic_bots_rnn: every GRU leaf (agent encoder, posterior, navi predictor, TL state predictor) and the RNN
    family's attention blocks, bit for bit, through the port's mapping and through JAX's + `params_from_jax`."""
    from trafficbotsv15_tpu import config as jc
    from trafficbotsv15_tpu.models.traffic_bots import TrafficBots

    sd, ins, _, meta = gm.load_golden("model", "traffic_bots_rnn")
    cfg = jc.ModelCfg(hidden_dim=64, temp_window_size=-1, tf_cfg=jc.TransformerCfg(d_model=64),
                      mp_encoder=jc.MapEncoderCfg(n_layer_tf=meta["n_layer_mp"]),
                      tl_encoder=jc.TlEncoderCfg(n_layer_tf=meta["n_layer_tl"]),
                      ag_encoder=jc.AgEncoderCfg(n_layer_tf=meta["n_layer_ag"]),
                      navi_predictor=jc.NaviPredictorCfg(n_layer_tf=meta["n_layer_navi"]))
    a = _j({k: v for k, v in ins.items() if k != "w"})

    def init_all(mdl):
        mp = mdl.encode_map(a["mp_valid"], a["mp_attr"], a["mp_pose"], a["mp_type"])
        tl = mdl.precompute_tl(a["tl_valid"], a["tl_attr"], a["tl_pose"], mp)
        mdl.encode_latent(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], a["tl_state"], mp,
                          tl, posterior=True)
        mdl.predict_navi(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], mp)
        return mdl.step(a["ag_valid"][:, :, 0], a["ag_valid"][:, :, 0:1], a["ag_pose"][:, :, 0:1],
                        a["ag_motion"][:, :, 0:1], a["tl_state"][:, :, 0:1], jnp.zeros((1,), bool), a["ag_attr"],
                        a["ag_type"], a["ag_latent"], jnp.ones(a["ag_navi"].shape, bool), a["ag_navi"],
                        a["ag_navi_valid"], tl, mp)

    flax_params = _flax_params(TrafficBots(cfg=cfg, time_step_gt=meta["time_step_gt"]), method=init_all)
    want = params_from_jax(jti.conform(jti.map_traffic_bots(sd, cfg, meta["time_step_gt"]), flax_params))
    model = gm.full_model("traffic_bots_rnn", "cpu")[0]  # through load_reference_state_dict
    _assert_bit_equal(model.state_dict(), want)
    assert any(".gru2.hn.bias" in k for k in want)


def _full_golden():
    from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots

    sd, _, _, meta = gm.load_golden("model", "traffic_bots_full")
    cfg = gm.full_model_cfg(meta)
    return TrafficBots(cfg, pc.DataCfg(), time_step_gt=meta["time_step_gt"]), sd, cfg, meta["time_step_gt"]


def test_load_reference_state_dict_raises_on_a_missing_entry():
    model, sd, cfg, t_gt = _full_golden()
    del sd["ag_encoder.tf_ag2agmptl.layers.1.attn.in_proj_bias"]
    with pytest.raises(KeyError, match="ag_encoder.tf_ag2agmptl.layer1.attn"):
        ti.load_reference_state_dict(model, sd, cfg, t_gt)


@pytest.mark.parametrize("extra,message", [
    ("action_head.mlp_mean.0.fc_layers.6.weight", "does not read: .*'action_head.mlp_mean.0.fc_layers.6.weight'"),
    ("mp_encoder.tf_mp2mp.out_layernorm.weight", "no port parameter: .*'mp_encoder.tf_mp2mp.out_ln.weight'"),
])
def test_load_reference_state_dict_raises_on_an_extra_entry(extra, message):
    """An entry the mapping never reads, and one it reads into a parameter the port model does not have."""
    model, sd, cfg, t_gt = _full_golden()
    sd[extra] = np.ones(cfg.hidden_dim, np.float32)
    sd[extra.replace(".weight", ".bias")] = np.zeros(cfg.hidden_dim, np.float32)
    with pytest.raises(KeyError, match=message):
        ti.load_reference_state_dict(model, sd, cfg, t_gt)


def test_load_reference_state_dict_raises_on_a_transposed_weight():
    model, sd, cfg, t_gt = _full_golden()
    key = "mp_encoder.tf_mp2mp.layers.0.linear1.weight"
    sd[key] = np.ascontiguousarray(sd[key].T)
    with pytest.raises(KeyError, match="shape mismatch at mp_encoder.tf_mp2mp.layer0.ffn1.weight"):
        ti.load_reference_state_dict(model, sd, cfg, t_gt)


def test_load_reference_state_dict_fills_every_parameter():
    model, sd, cfg, t_gt = _full_golden()
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    ti.load_reference_state_dict(model, sd, cfg, t_gt)
    assert all(torch.isfinite(p).all() for p in model.parameters())
