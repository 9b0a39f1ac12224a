"""The port's parameters in the reference's state_dict layout: the inverse of `utils/torch_import.py`.

`reference_state_dict(model, data)` walks a port `TrafficBots` and writes
what the original PyTorch model's `state_dict()` would hold for the same
weights, under the reference's names (`tests/golden/model/traffic_bots_full.npz`
shows them): the fused `in_proj_weight`, `linear_rpe`, the nn.Sequential
numbering of each MLP (read from the port module's own layer settings),
`norm_tgt`, `mlp_mean.{i}` / `log_std.{i}`, `latent_dist_*`. It also writes
the entries the reference holds and the port has no parameter for, so that
the key set is the reference's:
  - the pose embeddings' frequency buffers and the node / history one-hot
    tables, computed from the config as the reference does;
  - `norm_tgt` of the self-attention layers at its initial value (ones,
    zeros): the reference builds it in every layer and applies it only to
    cross-attention targets;
  - the encoders of a constant latent prior (std_gaus), which the reference
    builds and never runs, as zeros; the prior head's constant mean and
    log_std buffers.
Tests and `chip_smoke.py` use it to export a port model and load it back
through `load_reference_state_dict`. Imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import DataCfg
from trafficbotsv15_tpu_torch.models.agent_encoder import AgentEncoder
from trafficbotsv15_tpu_torch.models.heads import GaussianHead
from trafficbotsv15_tpu_torch.models.latent_encoder import LatentEncoder, StdGaussian
from trafficbotsv15_tpu_torch.models.map_encoder import MapEncoder
from trafficbotsv15_tpu_torch.models.mlp import MLP, LayerNorm, PolylineEncoder
from trafficbotsv15_tpu_torch.models.navigation import NaviEncoder, NaviPredictor
from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots
from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightEncoder
from trafficbotsv15_tpu_torch.models.transformer import AttentionRPE, TransformerBlock, TransformerLayer
from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig
from trafficbotsv15_tpu_torch.utils.torch_import import REFERENCE_BUFFERS, mlp_linear_indices

SD = Dict[str, np.ndarray]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy().copy()


def _layernorm(ln: LayerNorm, p: str, out: SD) -> None:
    out[f"{p}.weight"], out[f"{p}.bias"] = _np(ln.weight), _np(ln.bias)


def _mlp(m: MLP, p: str, out: SD) -> None:
    for i, (li, ln) in enumerate(mlp_linear_indices(m.n, m.use_layernorm, m.end_layer_activation, m.dropout_p)):
        fc = getattr(m, f"fc{i}")
        out[f"{p}.fc_layers.{li}.weight"] = _np(fc.weight)
        if fc.bias is not None:
            out[f"{p}.fc_layers.{li}.bias"] = _np(fc.bias)
        if ln is not None:
            _layernorm(getattr(m, f"ln{i}"), f"{p}.fc_layers.{ln}", out)


def _attention(a: AttentionRPE, p: str, out: SD) -> None:
    out[f"{p}.in_proj_weight"] = np.concatenate([_np(a.q_proj.weight), _np(a.kv_w).T])
    if a.q_proj.bias is not None:
        out[f"{p}.in_proj_bias"] = np.concatenate([_np(a.q_proj.bias), _np(a.kv_b)])
    out[f"{p}.out_proj_weight"] = _np(a.out_proj.weight)
    if a.out_proj.bias is not None:
        out[f"{p}.out_proj_bias"] = _np(a.out_proj.bias)
    if a.d_rpe > 0:
        out[f"{p}.linear_rpe.weight"] = np.ascontiguousarray(_np(a.rpe_proj_w).T)
        out[f"{p}.linear_rpe.bias"] = _np(a.rpe_proj_b)


def _layer(layer: TransformerLayer, p: str, out: SD) -> None:
    _layernorm(layer.norm1, f"{p}.norm1", out)
    _layernorm(layer.norm2, f"{p}.norm2", out)
    _attention(layer.attn, f"{p}.attn", out)
    for ours, theirs in (("ffn1", "linear1"), ("ffn2", "linear2")):
        dense = getattr(layer, ours)
        out[f"{p}.{theirs}.weight"] = _np(dense.weight)
        if dense.bias is not None:
            out[f"{p}.{theirs}.bias"] = _np(dense.bias)
    if hasattr(layer, "norm_tgt_scale"):
        out[f"{p}.norm_tgt.weight"], out[f"{p}.norm_tgt.bias"] = _np(layer.norm_tgt_scale), _np(layer.norm_tgt_bias)
    else:  # built, never applied, at its initial value
        d = layer.norm1.weight.shape[0]
        out[f"{p}.norm_tgt.weight"], out[f"{p}.norm_tgt.bias"] = np.ones(d, np.float32), np.zeros(d, np.float32)
    if layer.mode == "dec_cross_attn":
        _layernorm(layer.norm_src, f"{p}.norm_src", out)
        _attention(layer.attn_src, f"{p}.attn_src", out)


def _freqs(p: str, cfg: PoseEmbConfig, out: SD) -> None:
    """The reference's sinusoid frequency buffers, each frequency twice (cos and sin slots)."""
    if cfg.mode == "mpa_pl":
        return
    if cfg.mode != "pe_xy_yaw":
        raise NotImplementedError(f"the frequency buffers of pose embedding {cfg.mode!r}")
    quarter = cfg.pe_dim // 4
    xy = 1.0 / np.power(np.float32(cfg.theta_xy), np.arange(0, quarter, 2, dtype=np.float32) / quarter)
    out[f"{p}.pe_xy.freqs"] = np.repeat(xy, 2).astype(np.float32)
    out[f"{p}.pe_yaw.freqs"] = np.repeat(np.arange(1, quarter + 1, dtype=np.float32), 2)


def _head(m, p: str, out: SD) -> None:
    """GaussianHead (the action head, a diag_gaus latent head): `mean{i}` -> `mlp_mean.{i}`, `log_std{i}` ->
    `log_std.{i}` (a vector) or `mlp_log_std.{i}` (an MLP); unbranched heads drop the index."""
    for b in m.branches:
        theirs = f".{b}" if b else ""
        _mlp(getattr(m, f"mean{b}"), f"{p}.mlp_mean{theirs}", out)
        log_std = getattr(m, f"log_std{b}")
        if isinstance(log_std, MLP):
            _mlp(log_std, f"{p}.mlp_log_std{theirs}", out)
        else:
            out[f"{p}.log_std{theirs}"] = _np(log_std)


def _walk(m: torch.nn.Module, p: str, out: SD, data: DataCfg) -> None:
    j = lambda name: f"{p}.{name}" if p else name
    if isinstance(m, MLP):
        _mlp(m, p, out)
    elif isinstance(m, TransformerBlock):
        for i, layer in enumerate(m.layers()):
            _layer(layer, j(f"layers.{i}"), out)
        if m.out_ln is not None:
            _layernorm(m.out_ln, j("out_layernorm"), out)
    elif isinstance(m, PolylineEncoder):
        for i in range(m.n_layer):
            _mlp(getattr(m, f"pointnet{i}"), j(f"mlp_layers.{i}"), out)
    elif isinstance(m, GaussianHead):
        _head(m, p, out)
    elif isinstance(m, StdGaussian):  # constant buffers
        out[j("mean")] = np.zeros((1, 1, m.out_dim), np.float32)
        out[j("log_std")] = np.zeros(m.out_dim, np.float32)
    else:
        rename = {"dist_post": "latent_dist_post", "dist_prior": "latent_dist_prior"}
        for name, child in m.named_children():
            _walk(child, j(rename.get(name, name)), out, data)
    if isinstance(m, MapEncoder):
        n = data.n_mp_pl_node
        out[j("pl_node_ohe")] = np.eye(n, dtype=np.float32)[None, None]
    if isinstance(m, (TrafficLightEncoder, AgentEncoder, NaviPredictor)):
        out[j("hist_ohe")] = np.eye(m.temp_window_size, dtype=np.float32)
    if isinstance(m, (MapEncoder, TrafficLightEncoder, AgentEncoder, NaviPredictor)):
        _freqs(j("pose_rpe"), m.pose_rpe, out)
    if isinstance(m, (AgentEncoder, NaviPredictor)):
        _freqs(j("pose_emb"), m.pe_cfg, out)
    if isinstance(m, NaviEncoder):
        _freqs(j("pose_emb"), m.pose_rpe, out)
    if isinstance(m, NaviPredictor) and hasattr(m, "log_std"):  # goal mode's learned std, a raw parameter
        out[j("log_std")] = _np(m.log_std)
    if isinstance(m, LatentEncoder) and not m.dummy and m.dist_prior.skips_forward:
        # the reference builds the prior's encoders beside the posterior's and never runs them
        if m.cfg.share_post_prior_encoders or m.dist_post.skips_forward:
            raise NotImplementedError("the reference layout of shared or constant posterior encoders")
        for key in [k for k in out if k.startswith(j("tl_encoder_post.")) or k.startswith(j("ag_encoder_post."))]:
            val = out[key]
            leaf = key.rsplit(".", 1)[-1]
            out[key.replace("_encoder_post.", "_encoder_prior.", 1)] = (
                val.copy() if leaf in REFERENCE_BUFFERS else np.zeros_like(val))
    if isinstance(m, TrafficBots):
        _freqs("pose_rpe", m.mp_encoder.pose_rpe, out)


def reference_state_dict(model: TrafficBots, data: DataCfg = DataCfg()) -> SD:
    """The reference state_dict {name: float32 array} of a port TrafficBots' weights."""
    out: SD = {}
    _walk(model, "", out, data)
    return out
