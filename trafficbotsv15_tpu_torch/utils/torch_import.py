"""Map reference torch state_dicts onto the port's modules.

The reference is the original PyTorch TrafficBots V1.5 (the code
`scripts/gen_model_golden.py` ran to make `tests/golden/model/*.npz`). Its
`state_dict` names follow its own module tree (`sd/*` keys of the goldens);
this module maps them onto the port's `state_dict()` names, so a reference
checkpoint, or a golden's weights, loads into the port. It is the port's own
copy of the JAX package's rules (`trafficbotsv15_tpu/utils/torch_import.py`);
the port's parameter names already follow the flax paths
(`utils/jax_import.py`), and its layout is torch's, so most leaves copy as
they are.

Layout changes, reference -> port:
  - nn.Linear `weight [out, in]` stays `weight [out, in]`; LayerNorm
    `weight` / `bias` keep their names.
  - AttentionRPE fuses q/k/v into `in_proj_weight [3d, d]` (rows 0:d = q,
    d:3d = k then v) and `in_proj_bias [3d]`. The port keeps `q_proj`
    (a Dense: `weight = W[:d]`, `bias = b[:d]`) and the raw `[in, out]`
    matrix `kv_w = W[d:].T` with `kv_b = b[d:]`; its column blocks are (k, v),
    as torch chunks the projection's output.
  - `linear_rpe` (`[2d, d_rpe]`) becomes the raw `rpe_proj_w = W.T`
    `[d_rpe, 2d]` and `rpe_proj_b`. The `apply_q_rpe` layout (`[3d, d_rpe]`,
    rows (q, k, v)) is the port's `rpe_proj` Dense as it is.
  - The reference MLP wraps its layers in one nn.Sequential whose indices
    skip the activation and dropout slots; `mlp_linear_indices` reproduces
    that numbering from the constructor's logic, and the port names the
    layers `fc{i}` / `ln{i}`.
  - The per-layer target LayerNorm `norm_tgt` of the cross-attention layers
    maps onto the layer's `norm_tgt_scale` / `norm_tgt_bias`, which the port
    folds into the K/V projection (`models/transformer.py::AttentionRPE._kv_wb`).
    The reference builds `norm_tgt` in every layer; the port has it only where
    the layer attends over KNN cross targets, and `conform` drops the rest.
  - `nn.GRU` (the TrafficBots RNN family) stacks its gates row-wise
    `[3h, .]` in (reset, update, new) order with both `b_ih` and `b_hh`;
    the port's flax-style cells (`models/gru.py`) keep input biases only,
    plus `hn`'s: `ir.bias = b_ih[r] + b_hh[r]` (z likewise), `in.bias =
    b_ih[n]`, `hn.bias = b_hh[n]`, which stays inside the reset-gated term
    in both; the weights keep torch's `[out, in]` rows (`map_gru`).

Every `map_*` takes `sd`, a flat dict {reference name -> array} (a
state_dict converted with `.numpy()`, or a golden's `sd/` entries), and a
prefix `p` ('' at the root), and returns a flat dict {port name relative to
the module -> np.ndarray}. A mapped dict may hold entries the port model
does not have (both norm_tgt layouts); `conform` intersects it with the
model's `state_dict()`, and `load_reference_state_dict` loads it strictly.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Array = np.ndarray
SD = Mapping[str, Array]
Flat = Dict[str, Array]

# reference entries that hold no learned weight: the pose embeddings' frequency buffers and the
# one-hot tables of polyline nodes and history steps, all computed from the config
REFERENCE_BUFFERS = ("freqs", "pl_node_ohe", "hist_ohe")
# mapped entries the port has no parameter for in some layers (see the module docstring)
NORM_TGT_LAYOUTS = ("norm_tgt.weight", "norm_tgt.bias", "norm_tgt_scale", "norm_tgt_bias")


def _j(p: str, name: str) -> str:
    return p + "." + name if p else name


def _t(w: Array) -> Array:
    return np.ascontiguousarray(np.asarray(w).T)


def _sub(prefix: str, flat: Flat) -> Flat:
    return {f"{prefix}.{k}": v for k, v in flat.items()}


def map_linear(sd: SD, p: str) -> Flat:
    out = {"weight": np.asarray(sd[_j(p, "weight")])}
    if _j(p, "bias") in sd:
        out["bias"] = np.asarray(sd[_j(p, "bias")])
    return out


def map_layernorm(sd: SD, p: str) -> Flat:
    return {"weight": np.asarray(sd[_j(p, "weight")]), "bias": np.asarray(sd[_j(p, "bias")])}


def mlp_linear_indices(n_lin: int, use_layernorm: bool, end_layer_activation: bool,
                       dropout_p: float) -> List[Tuple[int, Optional[int]]]:
    """Sequential indices of (Linear, LayerNorm) for each logical MLP layer, as the reference's
    constructor numbers them: Linear, [LayerNorm], activation (not after the last layer unless
    end_layer_activation), [Dropout when dropout_p > 0]."""
    idx, out = 0, []
    for i in range(n_lin):
        lin_idx, ln_idx = idx, None
        idx += 1
        if (i < n_lin - 1) or end_layer_activation:
            if use_layernorm:
                ln_idx = idx
                idx += 1
            idx += 1  # activation
        if dropout_p > 0:
            idx += 1  # dropout
        out.append((lin_idx, ln_idx))
    return out


def map_mlp(sd: SD, p: str, n_lin: int, use_layernorm: bool = False, end_layer_activation: bool = True,
            dropout_p: float = -1.0) -> Flat:
    out: Flat = {}
    for i, (li, ln) in enumerate(mlp_linear_indices(n_lin, use_layernorm, end_layer_activation, dropout_p)):
        out.update(_sub(f"fc{i}", map_linear(sd, _j(p, f"fc_layers.{li}"))))
        if ln is not None:
            out.update(_sub(f"ln{i}", map_layernorm(sd, _j(p, f"fc_layers.{ln}"))))
    return out


def map_attention(sd: SD, p: str, d_model: int, apply_q_rpe: bool = False) -> Flat:
    """Reference AttentionRPE -> `models/transformer.py::AttentionRPE`."""
    w_in = np.asarray(sd[_j(p, "in_proj_weight")])  # [3d, d]
    out = {"q_proj.weight": np.ascontiguousarray(w_in[:d_model]), "kv_w": _t(w_in[d_model:]),
           "out_proj.weight": np.asarray(sd[_j(p, "out_proj_weight")])}
    if _j(p, "in_proj_bias") in sd:
        b_in = np.asarray(sd[_j(p, "in_proj_bias")])
        out["q_proj.bias"] = b_in[:d_model]
        out["kv_b"] = b_in[d_model:]
    if _j(p, "out_proj_bias") in sd:
        out["out_proj.bias"] = np.asarray(sd[_j(p, "out_proj_bias")])
    if _j(p, "linear_rpe.weight") in sd and apply_q_rpe:
        out.update(_sub("rpe_proj", map_linear(sd, _j(p, "linear_rpe"))))
    elif _j(p, "linear_rpe.weight") in sd:
        out["rpe_proj_w"] = _t(sd[_j(p, "linear_rpe.weight")])
        out["rpe_proj_b"] = np.asarray(sd[_j(p, "linear_rpe.bias")])
    return out


def map_transformer_layer(sd: SD, p: str, d_model: int, mode: str, apply_q_rpe: bool = False) -> Flat:
    """Reference TransformerRPE -> `models/transformer.py::TransformerLayer`, with both norm_tgt layouts."""
    out = {**_sub("norm1", map_layernorm(sd, _j(p, "norm1"))), **_sub("norm2", map_layernorm(sd, _j(p, "norm2"))),
           **_sub("attn", map_attention(sd, _j(p, "attn"), d_model, apply_q_rpe)),
           **_sub("ffn1", map_linear(sd, _j(p, "linear1"))), **_sub("ffn2", map_linear(sd, _j(p, "linear2")))}
    if _j(p, "norm_tgt.weight") in sd:
        ln = map_layernorm(sd, _j(p, "norm_tgt"))
        out.update(_sub("norm_tgt", ln))
        out["norm_tgt_scale"], out["norm_tgt_bias"] = ln["weight"], ln["bias"]
    if mode == "dec_cross_attn":
        out.update(_sub("norm_src", map_layernorm(sd, _j(p, "norm_src"))))
        out.update(_sub("attn_src", map_attention(sd, _j(p, "attn_src"), d_model, apply_q_rpe)))
    return out


def map_transformer_block(sd: SD, p: str, d_model: int, n_layer: int, mode: str, apply_q_rpe: bool = False) -> Flat:
    out: Flat = {}
    for i in range(n_layer):
        out.update(_sub(f"layer{i}", map_transformer_layer(sd, _j(p, f"layers.{i}"), d_model, mode, apply_q_rpe)))
    if _j(p, "out_layernorm.weight") in sd:
        out.update(_sub("out_ln", map_layernorm(sd, _j(p, "out_layernorm"))))
    return out


def map_polyline_encoder(sd: SD, p: str, n_layer: int, use_layernorm: bool = False, dropout_p: float = -1.0) -> Flat:
    """PointNet PolylineEncoder: each `mlp_layers.{i}` is MLP([h, h//2]), one Linear (+LN) per level."""
    out: Flat = {}
    for i in range(n_layer):
        out.update(_sub(f"pointnet{i}", map_mlp(sd, _j(p, f"mlp_layers.{i}"), 1, use_layernorm, True, dropout_p)))
    return out


def map_input_encoder(sd: SD, p: str, n_layer: int, use_layernorm: bool = False, dropout_p: float = -1.0) -> Flat:
    return _sub("mlp", map_mlp(sd, _j(p, "mlp"), n_layer, use_layernorm, False, dropout_p))


def map_gru(sd: SD, p: str, n_layer: int, hidden: int) -> Flat:
    """Reference MultiAgentGRU (its `nn.GRU` at `rnn`) -> `models/gru.py::MultiAgentGRU`."""
    out: Flat = {}
    h = hidden
    for k in range(n_layer):
        w_ih = np.asarray(sd[_j(p, f"rnn.weight_ih_l{k}")])  # [3h, in]
        w_hh = np.asarray(sd[_j(p, f"rnn.weight_hh_l{k}")])  # [3h, h]
        b_ih = np.asarray(sd[_j(p, f"rnn.bias_ih_l{k}")])
        b_hh = np.asarray(sd[_j(p, f"rnn.bias_hh_l{k}")])
        rows = {"r": slice(0, h), "z": slice(h, 2 * h), "n": slice(2 * h, 3 * h)}
        for g, rs in rows.items():
            out[f"gru{k}.i{g}.weight"] = np.ascontiguousarray(w_ih[rs])
            out[f"gru{k}.h{g}.weight"] = np.ascontiguousarray(w_hh[rs])
        out[f"gru{k}.ir.bias"] = b_ih[rows["r"]] + b_hh[rows["r"]]
        out[f"gru{k}.iz.bias"] = b_ih[rows["z"]] + b_hh[rows["z"]]
        out[f"gru{k}.in.bias"] = b_ih[rows["n"]]
        out[f"gru{k}.hn.bias"] = b_hh[rows["n"]]
    return out


def map_action_head(sd: SD, p: str, n_layer: int, branch_type: bool, use_layernorm: bool,
                    learned_log_std: bool, n_type: int = 3) -> Flat:
    out: Flat = {}
    suffixes = [(f"{i}", f".{i}") for i in range(n_type)] if branch_type else [("", "")]
    for ours, theirs in suffixes:
        out.update(_sub(f"mean{ours}", map_mlp(sd, _j(p, f"mlp_mean{theirs}"), n_layer, use_layernorm, False)))
        if learned_log_std:
            out[f"log_std{ours}"] = np.asarray(sd[_j(p, f"log_std{theirs}")])
        else:
            out.update(_sub(f"log_std{ours}", map_mlp(sd, _j(p, f"mlp_log_std{theirs}"), n_layer, use_layernorm,
                                                      False)))
    return out


def map_add_navi_latent(sd: SD, p: str, n_layer: int, use_layernorm: bool, dropout_p: float) -> Flat:
    if _j(p, "mlp_in.fc_layers.0.weight") not in sd:
        return {}  # dummy
    return {**_sub("mlp_in", map_mlp(sd, _j(p, "mlp_in"), n_layer, use_layernorm, True, dropout_p)),
            **_sub("mlp", map_mlp(sd, _j(p, "mlp"), n_layer, use_layernorm, True, dropout_p))}


def map_dist_encoder(sd: SD, p: str, dist_type: str, n_layer: int, branch_type: bool,
                     use_layernorm: bool, learned_log_std: bool) -> Flat:
    """Reference DistEncoder -> `models/latent_encoder.py::dist_encoder` (diag_gaus: `heads.py::GaussianHead`)."""
    if dist_type in ("std_gaus", "std_cat"):
        return {}  # constant heads: no learned weight
    if dist_type == "diag_gaus":
        return map_action_head(sd, p, n_layer, branch_type, use_layernorm, learned_log_std)
    if dist_type == "cat":
        if branch_type:
            out: Flat = {}
            for i in range(3):
                out.update(_sub(f"logits{i}", map_mlp(sd, _j(p, f"mlp_logits.{i}"), n_layer, use_layernorm, False)))
            return out
        return _sub("logits", map_mlp(sd, _j(p, "mlp_logits"), n_layer, use_layernorm, False))
    raise ValueError(f"latent head {dist_type!r}")


def map_tl_predictor(sd: SD, p: str, n_layer: int, hidden: int, temp_window_size: int) -> Flat:
    out = _sub("mlp", map_mlp(sd, _j(p, "mlp"), n_layer, False, False))
    if temp_window_size <= 0:
        out.update(_sub("rnn", map_gru(sd, _j(p, "rnn"), n_layer, hidden)))
    return out


# --------------------------------------------------------------- composites


def map_map_encoder(sd: SD, p: str, cfg, d_model: int, apply_q_rpe: bool = False) -> Flat:
    """MapEncoder; cfg is config.MapEncoderCfg."""
    ie, pl = cfg.input_encoder, cfg.pl_encoder
    return {
        **_sub("input_encoder", map_input_encoder(sd, _j(p, "input_encoder"), ie.n_layer, ie.mlp_use_layernorm,
                                                  ie.mlp_dropout_p)),
        **_sub("pl_encoder", map_polyline_encoder(sd, _j(p, "pl_encoder"), pl.n_layer, pl.mlp_use_layernorm,
                                                  pl.mlp_dropout_p)),
        **_sub("tf_mp2mp", map_transformer_block(sd, _j(p, "tf_mp2mp"), d_model, cfg.n_layer_tf, "enc_self_attn",
                                                 apply_q_rpe)),
    }


def map_tl_encoder(sd: SD, p: str, cfg, d_model: int, temp_window_size: int, pl_cfg,
                   apply_q_rpe: bool = False) -> Flat:
    """TrafficLightEncoder; cfg is TlEncoderCfg, pl_cfg the map encoder's pl_encoder cfg (its temp_encoder's)."""
    ie = cfg.input_encoder
    out = _sub("input_encoder", map_input_encoder(sd, _j(p, "input_encoder"), ie.n_layer, ie.mlp_use_layernorm,
                                                  ie.mlp_dropout_p))
    if temp_window_size <= 0:  # the RNN TL encoder is its input encoder
        return out
    if not cfg.temp_stack_input:
        out.update(_sub("temp_encoder", map_polyline_encoder(sd, _j(p, "temp_encoder"), pl_cfg.n_layer,
                                                             pl_cfg.mlp_use_layernorm, pl_cfg.mlp_dropout_p)))
    out.update(_sub("tf_tl2tlmp", map_transformer_block(sd, _j(p, "tf_tl2tlmp"), d_model, cfg.n_layer_tf,
                                                        "dec_cross_attn", apply_q_rpe)))
    return out


def map_agent_encoder(sd: SD, p: str, cfg, d_model: int, temp_window_size: int, pl_cfg, hidden: int,
                      apply_q_rpe: bool = False) -> Flat:
    """AgentEncoder (HPTR temporal tokens, or the RNN family's attention blocks and GRU); cfg is AgEncoderCfg."""
    ie = cfg.input_encoder
    out = _sub("input_encoder", map_input_encoder(sd, _j(p, "input_encoder"), ie.n_layer, ie.mlp_use_layernorm,
                                                  ie.mlp_dropout_p))
    if temp_window_size <= 0:
        out.update(_sub("temp_encoder", map_gru(sd, _j(p, "temp_encoder"), pl_cfg.n_layer, hidden)))
        for name, mode in (("tf_ag2mp", "enc_cross_attn"), ("tf_ag2tl", "enc_cross_attn"), ("tf_ag2ag", "enc_self_attn")):
            out.update(_sub(name, map_transformer_block(sd, _j(p, name), d_model, cfg.n_layer_tf, mode, apply_q_rpe)))
        return out
    out.update(_sub("temp_encoder", map_polyline_encoder(sd, _j(p, "temp_encoder"), pl_cfg.n_layer,
                                                         pl_cfg.mlp_use_layernorm, pl_cfg.mlp_dropout_p)))
    out.update(_sub("tf_ag2agmptl", map_transformer_block(sd, _j(p, "tf_ag2agmptl"), d_model, cfg.n_layer_tf,
                                                          "dec_cross_attn", apply_q_rpe)))
    return out


def _constant_head(dcfg) -> bool:
    return dcfg.dist_type in ("std_gaus", "std_cat")


def latent_encoder_names(cfg) -> List[str]:
    """The encoders (`{tl,ag}_encoder_{post,prior}`) the latent heads run: a constant head (std_gaus,
    std_cat) runs none."""
    names = []
    if not _constant_head(cfg.latent_post):
        names += ["tl_encoder_post", "ag_encoder_post"]
    if not _constant_head(cfg.latent_prior) and not (cfg.share_post_prior_encoders and names):
        names += ["tl_encoder_prior", "ag_encoder_prior"]
    return names


def idle_reference_prefixes(cfg) -> List[str]:
    """Prefixes of reference entries its forward never reads: the encoders of a constant latent head
    and that head's constant mean / log_std buffers; cfg is config.ModelCfg."""
    le = cfg.latent_encoder
    kept = latent_encoder_names(le)
    out = [f"latent_encoder.{k}_encoder_{w}." for k in ("tl", "ag") for w in ("post", "prior")
           if f"{k}_encoder_{w}" not in kept]
    out += [f"latent_encoder.latent_dist_{w}." for w, d in (("post", le.latent_post), ("prior", le.latent_prior))
            if _constant_head(d)]
    return out


def map_latent_encoder(sd: SD, p: str, cfg, tl_cfg, ag_cfg, d_model: int, latent_window: int, pl_cfg,
                       hidden: int, apply_q_rpe: bool = False) -> Flat:
    """LatentEncoder; cfg is LatentEncoderCfg."""
    if cfg.latent_dim <= 0:
        return {}
    out: Flat = {}
    for name in latent_encoder_names(cfg):
        if name.startswith("tl"):
            mapped = map_tl_encoder(sd, _j(p, name), tl_cfg, d_model, latent_window, pl_cfg, apply_q_rpe)
        else:
            mapped = map_agent_encoder(sd, _j(p, name), ag_cfg, d_model, latent_window, pl_cfg, hidden, apply_q_rpe)
        out.update(_sub(name, mapped))
    for ours, theirs, dcfg in (("dist_post", "latent_dist_post", cfg.latent_post),
                               ("dist_prior", "latent_dist_prior", cfg.latent_prior)):
        out.update(_sub(ours, map_dist_encoder(sd, _j(p, theirs), dcfg.dist_type, dcfg.n_layer, dcfg.branch_type,
                                               dcfg.mlp_use_layernorm, dcfg.log_std is not None)))
    return out


def map_navi_encoder(sd: SD, p: str, navi_mode: str, pairwise_relative: bool) -> Flat:
    if navi_mode == "dummy":
        return {}
    if navi_mode == "dest":
        out = _sub("mlp_mp", map_mlp(sd, _j(p, "mlp_mp"), 1, False, False))
        if pairwise_relative:
            out.update(_sub("mlp_pe", map_mlp(sd, _j(p, "mlp_pe"), 1, False, False)))
        return out
    return _sub("mlp", map_mlp(sd, _j(p, "mlp"), 1, False, False))  # goal / cmd


def map_navi_predictor(sd: SD, p: str, cfg, ag_cfg, d_model: int, temp_window_size: int, pl_cfg, hidden: int,
                       navi_mode: str, apply_q_rpe: bool = False) -> Flat:
    """NaviPredictor; cfg is NaviPredictorCfg."""
    if navi_mode == "dummy":
        return {}
    ie = ag_cfg.input_encoder
    out = {
        **_sub("input_encoder", map_input_encoder(sd, _j(p, "input_encoder"), ie.n_layer, ie.mlp_use_layernorm,
                                                  ie.mlp_dropout_p)),
        **_sub("mlp", map_mlp(sd, _j(p, "mlp"), cfg.n_layer_mlp, cfg.mlp_use_layernorm, False)),
        **_sub("temp_encoder", map_gru(sd, _j(p, "temp_encoder"), pl_cfg.n_layer, hidden) if temp_window_size <= 0
               else map_polyline_encoder(sd, _j(p, "temp_encoder"), pl_cfg.n_layer, pl_cfg.mlp_use_layernorm,
                                         pl_cfg.mlp_dropout_p)),
    }
    if navi_mode != "dest":
        out.update(_sub("tf_ag2mp", map_transformer_block(sd, _j(p, "tf_ag2mp"), d_model, cfg.n_layer_tf,
                                                          "enc_cross_attn", apply_q_rpe)))
        if navi_mode == "goal":
            out["log_std"] = np.asarray(sd[_j(p, "log_std")])
    return out


def latent_window(cfg, time_step_gt: int) -> int:
    rate = cfg.latent_encoder.temporal_down_sample_rate
    if cfg.temp_window_size <= 0:
        return cfg.temp_window_size
    return (time_step_gt + 1) // rate + 1 if rate > 1 else time_step_gt + 1


def map_traffic_bots(sd: SD, cfg, time_step_gt: int) -> Flat:
    """The whole reference TrafficBots -> `models/traffic_bots.py::TrafficBots`; cfg is config.ModelCfg."""
    c = cfg
    d, q = c.tf_cfg.d_model, c.tf_cfg.apply_q_rpe
    pl = c.mp_encoder.pl_encoder
    ah, an = c.action_head, c.add_navi_latent
    out = {
        **_sub("mp_encoder", map_map_encoder(sd, "mp_encoder", c.mp_encoder, d, q)),
        **_sub("tl_encoder", map_tl_encoder(sd, "tl_encoder", c.tl_encoder, d, c.temp_window_size, pl, q)),
        **_sub("tl_state_predictor", map_tl_predictor(sd, "tl_state_predictor", c.tl_state_predictor.n_layer,
                                                      c.hidden_dim, c.temp_window_size)),
        **_sub("ag_encoder", map_agent_encoder(sd, "ag_encoder", c.ag_encoder, d, c.temp_window_size, pl,
                                               c.hidden_dim, q)),
        **_sub("action_head", map_action_head(sd, "action_head", ah.n_layer, ah.branch_type, ah.mlp_use_layernorm,
                                              ah.log_std is not None)),
        **_sub("latent_encoder", map_latent_encoder(sd, "latent_encoder", c.latent_encoder, c.tl_encoder,
                                                    c.ag_encoder, d, latent_window(c, time_step_gt), pl,
                                                    c.hidden_dim, q)),
        **_sub("navi_encoder", map_navi_encoder(sd, "navi_encoder", c.navi_mode, c.pairwise_relative)),
        **_sub("navi_predictor", map_navi_predictor(sd, "navi_predictor", c.navi_predictor, c.ag_encoder, d,
                                                    c.temp_window_size, pl, c.hidden_dim, c.navi_mode, q)),
    }
    for name in ("add_navi", "add_latent"):
        out.update(_sub(name, map_add_navi_latent(sd, name, an.n_layer, an.mlp_use_layernorm, an.mlp_dropout_p)))
    return out


def conform(mapped: Mapping[str, Array], target: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Intersect a mapped dict with a port model's `state_dict()`.

    Keeps exactly the target's keys, each as a tensor of the target's dtype. Raises KeyError with the
    full name for a key the mapping lacks or a shape that differs (a transposed or mis-numbered weight,
    not a tolerable difference). Mapped entries the target lacks drop.
    """
    out = {}
    for name, t in target.items():
        if name not in mapped:
            raise KeyError(f"mapping missing param {name}")
        leaf = np.asarray(mapped[name])
        if tuple(leaf.shape) != tuple(t.shape):
            raise KeyError(f"shape mismatch at {name}: mapped {leaf.shape} vs target {tuple(t.shape)}")
        out[name] = torch.from_numpy(np.array(leaf, dtype=np.float32)).to(t.dtype)
    return out


class _ReadLog(dict):
    """The reference state_dict, logging every key a mapping reads."""

    def __init__(self, sd: SD):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def load_reference_state_dict(model: torch.nn.Module, sd: SD, cfg, time_step_gt: int) -> None:
    """Load a reference TrafficBots state_dict into the port's `model` (built from the ModelCfg `cfg`).

    Strict both ways, like `utils/jax_import.py::load_jax_params`: every port parameter is filled
    (`conform` raises otherwise); every sd entry the mapping reads lands in a port parameter, but for
    the norm_tgt layouts the port folds away; and every sd entry is read, but for the reference's
    config-derived buffers (`REFERENCE_BUFFERS`) and what `idle_reference_prefixes` names, which the
    reference never runs. A transposed weight fails the shape check.
    """
    log = _ReadLog(sd)
    mapped = map_traffic_bots(log, cfg, time_step_gt)
    state = conform(mapped, model.state_dict())
    dropped = sorted(k for k in mapped if k not in state and not k.endswith(NORM_TGT_LAYOUTS))
    if dropped:
        raise KeyError(f"reference weights with no port parameter: {dropped[:8]}")
    idle = tuple(idle_reference_prefixes(cfg))
    unread = sorted(k for k in sd if k not in log.read and k.rsplit(".", 1)[-1] not in REFERENCE_BUFFERS
                    and not k.startswith(idle))
    if unread:
        raise KeyError(f"reference entries the mapping does not read: {unread[:8]}")
    model.load_state_dict(state, strict=True)
