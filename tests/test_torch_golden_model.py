"""PyTorch port: the model blocks against the reference-torch goldens (`tests/golden/model/*.npz`).

Each golden holds the weights (`sd/`), inputs (`in/`) and outputs (`out/`)
of one of the original PyTorch modules in eval mode, as
`scripts/gen_model_golden.py` made them; `tests/test_model_parity.py` holds
the JAX package to the same files. Here the weights go through the port's
`utils/torch_import.py` into the port's module, the inputs through it, and
the outputs must agree at that JAX test's tolerance for the same golden:
  - `close`'s default atol 1e-5, rtol 1e-4 (MLPs, encoders, heads);
  - attention atol 2e-5; transformer blocks atol 5e-5;
  - the type-branched MLP log_std: atol 2e-5, rtol 1e-3;
  - the whole model 2e-4 / 1e-3 on the map and TL tokens, 5e-4 / 1e-3 on
    the action, the TL log-probs and the posterior latent, and 1e-4 / 1e-3
    on the navi probabilities.
KNN-fed blocks compare final features: the goldens' poses are continuous
random values, so the sets of KNN winners agree and slot order cancels.
Goldens whose modules carry `dropout_p` 0.1 are built with it (it shifts the
reference's MLP numbering) and run with the port's dropout off, as
evaluation runs.

Each case is one function `run_<case>(device, use_pallas, dense_knn_max)`
returning `Check`s (outputs beside golden values and tolerance). The tests
here call them on the CPU, where the KNARPE wrappers take their plain
versions; `chip_smoke.py` calls the same functions on the card, where
`use_pallas=True` launches the kernels. This file imports no JAX.

`load_golden` is the one loader of `tests/golden/{model,sim}/*.npz` for the
port's tests.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pytest
import torch

from trafficbotsv15_tpu_torch import config as pc
from trafficbotsv15_tpu_torch.utils import torch_import as ti

GOLD = Path(__file__).parent / "golden"
TORCH_THREADS = 2  # tier-1 runs several pytest workers side by side

# (atol, rtol) of tests/test_model_parity.py for each kind of golden
CLOSE, ATTN, BLOCK, BRANCH_STD = (1e-5, 1e-4), (2e-5, 1e-4), (5e-5, 1e-4), (2e-5, 1e-3)
FULL_TOKENS, FULL_HEADS, FULL_NAVI = (2e-4, 1e-3), (5e-4, 1e-3), (1e-4, 1e-3)
NAVI_GOAL_MEAN, NAVI_CMD_PROBS = (2e-4, 1e-3), (1e-5, 1e-3)


def load_golden(kind: str, name: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                                               Dict[str, np.ndarray], dict]:
    """(sd, ins, outs, meta) of `tests/golden/<kind>/<name>.npz`, each dict keyed without its
    `sd/`, `in/` or `out/` prefix; meta {} where the file has none."""
    with np.load(GOLD / kind / f"{name}.npz") as z:
        part = lambda pre: {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files else {}
        return part("sd/"), part("in/"), part("out/"), meta


@dataclasses.dataclass
class Check:
    """One output beside its golden value; passes where |got - want| <= atol + rtol * |want| everywhere
    (atol = rtol = 0: equal)."""

    name: str
    got: np.ndarray
    want: np.ndarray
    atol: float = 0.0
    rtol: float = 0.0

    def excess(self) -> float:
        """The largest |got - want| - (atol + rtol * |want|): <= 0 passes; inf on a shape mismatch or NaN."""
        got, want = np.asarray(self.got), np.asarray(self.want)
        if got.shape != want.shape:
            return float("inf")
        got, want = got.astype(np.float64), want.astype(np.float64)
        over = np.abs(got - want) - (self.atol + self.rtol * np.abs(want))
        return float(np.nan_to_num(over, nan=np.inf).max(initial=-np.inf))

    def max_abs_err(self) -> float:
        got, want = np.asarray(self.got, np.float64), np.asarray(self.want, np.float64)
        return float(np.abs(got - want).max(initial=0.0)) if got.shape == want.shape else float("inf")

    def assert_ok(self) -> None:
        assert self.excess() <= 0.0, (f"{self.name}: max |err| {self.max_abs_err():.3e} beyond atol {self.atol:g} "
                                      f"+ rtol {self.rtol:g} * |golden| (excess {self.excess():.3e})")


def assert_checks(checks: List[Check]) -> None:
    assert checks
    for c in checks:
        c.assert_ok()


def close(name, got, want, tol=CLOSE) -> Check:
    return Check(name, to_np(got), want, *tol)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.numpy() if x.dtype == torch.bool else x.float().numpy()
    return np.asarray(x)


def _inputs(ins, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in ins.items()}


def _loaded(module: torch.nn.Module, mapped, device) -> torch.nn.Module:
    """`module` with every parameter from the mapped golden weights (strict), in eval mode on `device`."""
    module.load_state_dict(ti.conform(mapped, module.state_dict()), strict=True)
    return module.to(device).eval()


def _tf_cfg(meta, use_pallas=False, dense_knn_max=128) -> pc.TransformerCfg:
    return pc.TransformerCfg(d_model=meta["d_model"], n_head=meta["n_head"], dropout_p=meta.get("dropout_p", 0.1),
                             k_feedforward=meta.get("k_feedforward", 4), bias=meta.get("bias", True),
                             out_layernorm=meta.get("out_layernorm", False),
                             apply_q_rpe=meta.get("apply_q_rpe", False), use_pallas=use_pallas,
                             dense_knn_max=dense_knn_max)


# ----------------------------------------------------------------- primitives


def run_mlp_ln(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    from trafficbotsv15_tpu_torch.models.mlp import MLP

    sd, ins, outs, meta = load_golden("model", "mlp_ln")
    a = _inputs(ins, device)
    m = _loaded(MLP(a["x"].shape[-1], meta["fc_dims"], use_layernorm=True, dropout_p=meta["dropout_p"]),
                ti.map_mlp(sd, "", 3, use_layernorm=True, dropout_p=meta["dropout_p"]), device)
    with torch.no_grad():
        return [close("y", m(a["x"], a["invalid"]), outs["y"])]


def run_mlp_plain(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    from trafficbotsv15_tpu_torch.models.mlp import MLP

    sd, ins, outs, meta = load_golden("model", "mlp_plain")
    a = _inputs(ins, device)
    m = _loaded(MLP(a["x"].shape[-1], meta["fc_dims"], end_layer_activation=False),
                ti.map_mlp(sd, "", 2, end_layer_activation=False), device)
    with torch.no_grad():
        return [close("y", m(a["x"]), outs["y"])]


def _input_encoder(mode, device):
    from trafficbotsv15_tpu_torch.models.mlp import InputEncoder

    sd, ins, outs, meta = load_golden("model", f"input_encoder_{mode}")
    a = _inputs(ins, device)
    m = _loaded(InputEncoder(a["attr"].shape[-1], 64, meta["pe_dim"], meta["n_layer"], mode),
                ti.map_input_encoder(sd, "", meta["n_layer"]), device)
    with torch.no_grad():
        return [close("y", m(a["attr"], a["pe"]), outs["y"])]


def run_input_encoder_cat(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _input_encoder("cat", device)


def run_input_encoder_add(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _input_encoder("add", device)


def run_input_encoder_input(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _input_encoder("input", device)


def run_polyline_encoder(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    from trafficbotsv15_tpu_torch.models.mlp import PolylineEncoder

    sd, ins, outs, meta = load_golden("model", "polyline_encoder")
    a = _inputs(ins, device)
    m = _loaded(PolylineEncoder(64, meta["n_layer"], meta["pooling_mode"], mlp_dropout_p=0.1),
                ti.map_polyline_encoder(sd, "", meta["n_layer"], dropout_p=0.1), device)
    with torch.no_grad():
        return [close("y", m(a["x"], a["invalid"]), outs["y"])]


def _attention(name, device, use_pallas):
    from trafficbotsv15_tpu_torch.models.transformer import AttentionRPE

    sd, ins, outs, meta = load_golden("model", name)
    a = _inputs(ins, device)
    mapped = ti.map_attention(sd, "", meta["d_model"], meta.get("apply_q_rpe", False))
    m = _loaded(AttentionRPE(meta["d_model"], meta["n_head"], d_rpe=meta.get("d_rpe", -1), use_pallas=use_pallas,
                             dropout_p=0.1, apply_q_rpe=meta.get("apply_q_rpe", False)), mapped, device)
    with torch.no_grad():
        y = m(a["src"], a.get("tgt"), tgt_padding_mask=a["pad"], rpe=a.get("rpe"))
    return [close("y", y, outs["y"], ATTN)]


def run_attn_knn(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _attention("attn_knn", device, use_pallas)


def run_attn_rpe(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _attention("attn_rpe", device, use_pallas)


def run_attn_rpe_q(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """The query RPE (rpe_q, rpe_k, rpe_v from one [3d, d_rpe] projection): the plain path whatever use_pallas says."""
    return _attention("attn_rpe_q", device, use_pallas)


def run_attn_dense_self(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _attention("attn_dense_self", device, use_pallas)


def run_attn_dense_cross(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _attention("attn_dense_cross", device, use_pallas)


def _block(name, device, use_pallas, dense_knn_max, **fields):
    from trafficbotsv15_tpu_torch.models.transformer import TransformerBlock

    sd, ins, outs, meta = load_golden("model", name)
    a = _inputs(ins, device)
    tf = _tf_cfg(meta, use_pallas, dense_knn_max)
    m = _loaded(TransformerBlock(tf, meta["n_layer"], meta["mode"], d_rpe=meta["d_rpe"]),
                ti.map_transformer_block(sd, "", meta["d_model"], meta["n_layer"], meta["mode"]), device)
    with torch.no_grad():
        y = m(a["src"], src_padding_mask=a["src_pad"], **{k: a[v] for k, v in fields.items()})
    return [close("y", y, outs["y"], BLOCK)]


def run_tfblock_enc_self_knn(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """KNN self-attention with rpe: dense-masked where n_src <= dense_knn_max, else project-then-gather (B4)."""
    return _block("tfblock_enc_self_knn", device, use_pallas, dense_knn_max,
                  tgt_idx="idx", tgt_padding_mask="knn_pad", rpe="rpe")


def run_tfblock_enc_cross(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _block("tfblock_enc_cross", device, use_pallas, dense_knn_max,
                  tgt="tgt", tgt_padding_mask="tgt_pad", rpe="rpe")


def run_tfblock_dec_cross(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _block("tfblock_dec_cross", device, use_pallas, dense_knn_max,
                  tgt="tgt", tgt_padding_mask="tgt_pad", rpe="rpe", decoder_tgt_idx="dec_idx",
                  decoder_tgt_padding_mask="dec_pad", decoder_rpe="dec_rpe")


def run_tfblock_dense_self(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _block("tfblock_dense_self", device, use_pallas, dense_knn_max)


# ----------------------------------------------------------------- heads


def _action_head(name, device):
    from trafficbotsv15_tpu_torch.models.heads import GaussianHead

    sd, ins, outs, meta = load_golden("model", name)
    a = _inputs(ins, device)
    cfg = pc.ActionHeadCfg(log_std=meta["log_std"], n_layer=meta["n_layer"], branch_type=meta["branch_type"],
                           mlp_use_layernorm=meta.get("mlp_use_layernorm", False))
    mapped = ti.map_action_head(sd, "", cfg.n_layer, cfg.branch_type, cfg.mlp_use_layernorm, cfg.log_std is not None)
    m = _loaded(GaussianHead(cfg, 64, 2, a["ag_type"].shape[-1], fp32_out=True), mapped, device)
    with torch.no_grad():
        dist = m(a["x"], a["valid"], a["ag_type"])
    return [close("mean", dist.mean, outs["mean"]), close("std", dist.std, outs["std"])]


def run_action_head_branch(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _action_head("action_head_branch", device)


def run_action_head_mlp_std(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _action_head("action_head_mlp_std", device)


def _add_navi(mode, device):
    from trafficbotsv15_tpu_torch.models.heads import AddNaviLatent

    sd, ins, outs, meta = load_golden("model", f"add_navi_{mode}")
    a = _inputs(ins, device)
    cfg = pc.AddNaviLatentCfg(mode=mode, res_add=meta["res_add"], n_layer=meta["n_layer"], mlp_dropout_p=0.1)
    m = _loaded(AddNaviLatent(cfg, 64, a["z"].shape[-1]), ti.map_add_navi_latent(sd, "", cfg.n_layer, False, 0.1),
                device)
    with torch.no_grad():
        return [close("y", m(a["x"], a["z"], a["z_valid"]), outs["y"])]


def run_add_navi_cat(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _add_navi("cat", device)


def run_add_navi_add(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _add_navi("add", device)


def run_add_navi_mul(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _add_navi("mul", device)


def _dist_encoder(name, device, std_tol=CLOSE):
    from trafficbotsv15_tpu_torch.models.latent_encoder import dist_encoder

    sd, ins, outs, meta = load_golden("model", name)
    a = _inputs(ins, device)
    cfg = pc.DistEncoderCfg(dist_type=meta["dist_type"], n_layer=meta.get("n_layer", 3),
                            branch_type=meta.get("branch_type", False), n_cat=meta.get("n_cat", 8),
                            log_std=meta.get("log_std"))
    mapped = ti.map_dist_encoder(sd, "", cfg.dist_type, cfg.n_layer, cfg.branch_type, False, cfg.log_std is not None)
    m = _loaded(dist_encoder(cfg, 64, 16, a["ag_type"].shape[-1]), mapped, device)
    with torch.no_grad():
        dist = m(a["x"], a["valid"], a["ag_type"])
        if cfg.dist_type in ("cat", "std_cat"):
            checks = [close("logits", dist.logits, outs["logits"])]
            if "sample" in a:
                checks.append(close("log_prob", dist.log_prob(a["sample"]), outs["log_prob"]))
            return checks
    return [close("mean", dist.mean, outs["mean"]), close("std", dist.std, outs["std"], std_tol)]


def run_dist_enc_diag_gaus(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _dist_encoder("dist_enc_diag_gaus", device)


def run_dist_enc_diag_gaus_branch(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _dist_encoder("dist_enc_diag_gaus_branch", device, std_tol=BRANCH_STD)


def run_dist_enc_cat_branch(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """The type-branched `cat` head: one logits MLP per agent type, each masked to its type, summed."""
    return _dist_encoder("dist_enc_cat_branch", device)


def run_dist_enc_cat_plain(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return _dist_encoder("dist_enc_cat_plain", device)


def run_dist_enc_std_cat(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """The parameter-free `std_cat` head's zero logits and its `MultiCategorical.log_prob` of the golden's one-hot."""
    return _dist_encoder("dist_enc_std_cat", device)


def run_tl_predictor_hptr(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightStatePredictor

    sd, ins, outs, meta = load_golden("model", "tl_predictor_hptr")
    a = _inputs(ins, device)
    m = _loaded(TrafficLightStatePredictor(pc.TlStatePredictorCfg(n_layer=meta["n_layer"]), 64, 5,
                                           meta["temp_window_size"]),
                ti.map_tl_predictor(sd, "", meta["n_layer"], 64, meta["temp_window_size"]), device)
    with torch.no_grad():
        return [close("y", m(a["x"], a["invalid"])[0], outs["y"])]


# ------------------------------------------------- the TrafficBots RNN family's GRU


def _gru(name, device):
    """(port MultiAgentGRU loaded with the golden's `nn.GRU` weights, inputs, outs): hidden 64, 2 layers, built
    with the reference's dropout 0.1 and run without it."""
    from trafficbotsv15_tpu_torch.models.gru import MultiAgentGRU

    sd, ins, outs, meta = load_golden("model", name)
    h, n_layer = meta["hidden"], meta["n_layer"]
    m = _loaded(MultiAgentGRU(h, h, n_layer, dropout_p=0.1), ti.map_gru(sd, "", n_layer, h), device)
    return m, _inputs(ins, device), outs


def run_gru_seq(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """The GRU over a track [n_sc, n_ag, n_step] with invalid steps (the RNN agent encoder's and navi
    predictor's temporal encoder)."""
    m, a, outs = _gru("gru_seq", device)
    with torch.no_grad():
        return [close("y", m(a["x"], a["invalid"])[0], outs["y"])]


def run_gru_step(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """One GRU step from a given hidden (the reference's [n_layer, n_sc * n_ag, d] layout), with invalid agents."""
    m, a, outs = _gru("gru_step", device)
    n_sc, n_ag = a["invalid"].shape
    with torch.no_grad():
        y, h1 = m(a["x"], a["invalid"], a["h"].reshape(-1, n_sc, n_ag, a["h"].shape[-1]))
    return [close("y", y, outs["y"]), close("h1", h1.reshape(a["h"].shape), outs["h1"])]


def _navi_predictor(name, device, use_pallas, dense_knn_max):
    """The goal / cmd navi predictor (as JAX `test_navi_predictor_goal_cmd_parity`: K = 32 nearest map polylines
    within 500 m x 1000, the pose embedding's thetas 1e3 / 1e1): its tf_ag2mp cross-attention takes B2 with
    use_pallas."""
    from trafficbotsv15_tpu_torch.models.navigation import NaviPredictor
    from trafficbotsv15_tpu_torch.models.tokens import MapTokens
    from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig

    sd, ins, outs, meta = load_golden("model", name)
    a = _inputs(ins, device)
    cfg = pc.NaviPredictorCfg(n_layer_tf=meta["n_layer_tf"], n_layer_mlp=meta["n_layer_mlp"])
    w = meta["temp_window_size"]
    tf = pc.TransformerCfg(d_model=64, use_pallas=use_pallas, dense_knn_max=dense_knn_max)
    mapped = ti.map_navi_predictor(sd, "", cfg, pc.AgEncoderCfg(), 64, w, pc.PolylineEncoderCfg(), 64,
                                   meta["navi_mode"])
    m = _loaded(NaviPredictor(cfg, pc.AgEncoderCfg(), tf, 64, meta["navi_mode"], w, 32, 500.0,
                              PoseEmbConfig(mode="pe_xy_yaw", pe_dim=64, theta_xy=1e3, theta_cs=1e1),
                              attr_dim=ins["ag_attr"].shape[-1], navi_dim=meta["navi_dim"]), mapped, device)
    mp = MapTokens(invalid=a["mp_invalid"], feature=a["mp_feature"], pose=a["mp_pose"], type=a["mp_type"])
    with torch.no_grad():
        dist = m(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], mp)
    if meta["navi_mode"] == "goal":
        return [close("mean", dist.mean, outs["mean"], NAVI_GOAL_MEAN), close("std", dist.std, outs["std"], ATTN)]
    return [close("probs", torch.softmax(dist.logits.float(), -1), outs["probs"], NAVI_CMD_PROBS)]


def run_navi_pred_cmd_hptr(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """cmd mode on the HPTR track encoder (temporal tokens over an 11-step window)."""
    return _navi_predictor("navi_pred_cmd_hptr", device, use_pallas, dense_knn_max)


def run_navi_pred_goal_rnn(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """goal mode on the GRU track encoder (res_add, pooled), its mean back in the world frame."""
    return _navi_predictor("navi_pred_goal_rnn", device, use_pallas, dense_knn_max)


def run_tl_encoder_stacked(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """The stacked-input TL encoder (`temp_stack_input`) over a 7-step window, left-padded to its 11 slots: the
    lane tokens' attr and the TL feature after 2 decoder layers (JAX `test_tl_encoder_stacked_parity`'s tolerances:
    `close`'s on the attr, 5e-5 / 1e-3 on the feature), its decoder self-attention dense-masked at dense_knn_max
    128 and project-then-gather at 0. Both attentions read the static K/V that `precompute` hoists: no kernel."""
    from trafficbotsv15_tpu_torch.models.tokens import MapTokens
    from trafficbotsv15_tpu_torch.models.traffic_light import TrafficLightEncoder
    from trafficbotsv15_tpu_torch.ops.pose_emb import PoseEmbConfig

    sd, ins, outs, meta = load_golden("model", "tl_encoder_stacked")
    a = _inputs(ins, device)
    w = meta["temp_window_size"]
    cfg = pc.TlEncoderCfg(temp_stack_input=True, n_layer_tf=meta["n_layer_tf"])
    tf = pc.TransformerCfg(d_model=64, use_pallas=use_pallas, dense_knn_max=dense_knn_max)
    m = _loaded(TrafficLightEncoder(cfg, tf, 64, 5, "lane", w, 32, 500.0, PoseEmbConfig(mode="pe_xy_yaw", pe_dim=64)),
                ti.map_tl_encoder(sd, "", cfg, 64, w, pc.PolylineEncoderCfg()), device)
    mp = MapTokens(invalid=a["mp_invalid"], feature=a["mp_feature"], pose=a["mp_pose"],
                   type=torch.ones(a["mp_invalid"].shape + (11,), dtype=torch.bool, device=device))
    with torch.no_grad():
        tok = m.precompute(a["tl_valid"], a["tl_attr"].long(), a["tl_pose"], mp)
        feat = m(a["tl_state"], tok)
    return [close("tl_token_attr", tok.attr, outs["tl_token_attr"]), close("tl_feature", feat, outs["tl_feature"],
                                                                           (5e-5, 1e-3))]


# ----------------------------------------------------------------- the whole model


def full_model_cfg(meta, use_pallas=False, dense_knn_max=128, temp_window_size=11) -> pc.ModelCfg:
    """The ModelCfg of `traffic_bots_{full,rnn}`: the defaults at hidden 64 and the golden's depths."""
    return pc.ModelCfg(
        hidden_dim=meta["hidden"], temp_window_size=temp_window_size,
        tf_cfg=pc.TransformerCfg(d_model=meta["hidden"], use_pallas=use_pallas, dense_knn_max=dense_knn_max),
        mp_encoder=pc.MapEncoderCfg(n_layer_tf=meta["n_layer_mp"]),
        tl_encoder=pc.TlEncoderCfg(n_layer_tf=meta["n_layer_tl"]),
        ag_encoder=pc.AgEncoderCfg(n_layer_tf=meta["n_layer_ag"]),
        navi_predictor=pc.NaviPredictorCfg(n_layer_tf=meta["n_layer_navi"]),
    )


def full_model(name, device, use_pallas=False, dense_knn_max=128):
    """(port TrafficBots loaded with the golden's reference weights through `load_reference_state_dict`,
    inputs on `device`, outs, meta)."""
    from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots

    sd, ins, outs, meta = load_golden("model", name)
    cfg = full_model_cfg(meta, use_pallas, dense_knn_max, meta.get("temp_window_size", 11))
    model = TrafficBots(cfg, pc.DataCfg(), time_step_gt=meta["time_step_gt"])
    ti.load_reference_state_dict(model, sd, cfg, meta["time_step_gt"])
    return model.to(device).eval(), _inputs({k: v for k, v in ins.items() if k != "w"}, device), outs, meta


def run_traffic_bots_full(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """Every stage of one policy step with the reference's weights, as JAX `test_traffic_bots_full_parity`
    and `test_traffic_bots_navi_latent_parity`: the map tokens, the TL token attr, the action and TL
    log-probs after one step, the navi probabilities and the posterior latent."""
    model, a, outs, meta = full_model("traffic_bots_full", device, use_pallas, dense_knn_max)
    w = int(meta["w"])
    with torch.no_grad():
        mp = model.encode_map(a["mp_valid"], a["mp_attr"], a["mp_pose"], a["mp_type"])
        tl = model.precompute_tl(a["tl_valid"], a["tl_attr"], a["tl_pose"], mp)
        tl_feature, tl_logits = model.step_tl(a["tl_state"][:, :, :w], torch.zeros(w, dtype=torch.bool,
                                                                                     device=device), tl)
        action = model.step(a["ag_valid"][:, :, w - 1], a["ag_valid"][:, :, :w], a["ag_pose"][:, :, :w],
                            a["ag_motion"][:, :, :w], a["ag_attr"], a["ag_type"], a["ag_latent"],
                            torch.ones(a["ag_navi"].shape, dtype=torch.bool, device=device), a["ag_navi"],
                            a["ag_navi_valid"], tl, mp, tl_feature)[0]
        navi = model.predict_navi(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], mp)
        latent = model.encode_latent(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"],
                                     a["tl_state"], mp, tl, posterior=True)
    return [
        Check("mp_token_invalid", to_np(mp.invalid), outs["mp_token_invalid"]),
        close("mp_token_feature", mp.feature, outs["mp_token_feature"], FULL_TOKENS),
        close("tl_token_attr", tl.attr, outs["tl_token_attr"], FULL_TOKENS),
        close("action_mean", action.mean, outs["action_mean"], FULL_HEADS),
        close("action_std", action.std, outs["action_std"], FULL_HEADS),
        close("tl_log_probs", torch.log_softmax(tl_logits, -1), outs["tl_log_probs"], FULL_HEADS),
        close("navi_probs", torch.softmax(navi.logits.float(), -1), outs["navi_probs"], FULL_NAVI),
        close("latent_post_mean", latent.mean, outs["latent_post_mean"], FULL_HEADS),
        close("latent_post_std", latent.std, outs["latent_post_std"], FULL_HEADS),
    ]


def run_traffic_bots_rnn(device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    """The TrafficBots RNN family with the reference's weights, as JAX `test_traffic_bots_rnn_parity` and
    `test_traffic_bots_rnn_navi_latent_parity`: 11 steps of `step` with the TL encoder and the GRU state
    predictor inside it and both hiddens carried, then the action, the TL log-probs and both hiddens (in
    the reference's [n_layer, n_sc * n_ag, d] layout); the navi probabilities and the posterior latent."""
    model, a, outs, meta = full_model("traffic_bots_rnn", device, use_pallas, dense_knn_max)
    rnn_h = tl_h = None
    with torch.no_grad():
        mp = model.encode_map(a["mp_valid"], a["mp_attr"], a["mp_pose"], a["mp_type"])
        tl = model.precompute_tl(a["tl_valid"], a["tl_attr"], a["tl_pose"], mp)
        for t in range(int(meta["w"])):
            action, tl_logits, rnn_h, tl_h = model.step(
                a["ag_valid"][:, :, t], a["ag_valid"][:, :, t:t + 1], a["ag_pose"][:, :, t:t + 1],
                a["ag_motion"][:, :, t:t + 1], a["ag_attr"], a["ag_type"], a["ag_latent"],
                torch.ones(a["ag_navi"].shape, dtype=torch.bool, device=device), a["ag_navi"], a["ag_navi_valid"],
                tl, mp, hist_tl_state=a["tl_state"][:, :, t:t + 1],
                hist_step_invalid=torch.zeros(1, dtype=torch.bool, device=device), rnn_hidden=rnn_h,
                tl_rnn_hidden=tl_h)
        navi = model.predict_navi(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"], mp)
        latent = model.encode_latent(a["ag_valid"], a["ag_attr"], a["ag_motion"], a["ag_pose"], a["ag_type"],
                                     a["tl_state"], mp, tl, posterior=True)
    return [
        close("action_mean", action.mean, outs["action_mean"], FULL_HEADS),
        close("action_std", action.std, outs["action_std"], FULL_HEADS),
        close("tl_log_probs", torch.log_softmax(tl_logits, -1), outs["tl_log_probs"], FULL_HEADS),
        close("rnn_hidden", rnn_h.reshape(outs["rnn_hidden"].shape), outs["rnn_hidden"], FULL_HEADS),
        close("tl_rnn_hidden", tl_h.reshape(outs["tl_rnn_hidden"].shape), outs["tl_rnn_hidden"], FULL_HEADS),
        close("navi_probs", torch.softmax(navi.logits.float(), -1), outs["navi_probs"], FULL_NAVI),
        close("latent_post_mean", latent.mean, outs["latent_post_mean"], FULL_HEADS),
        close("latent_post_std", latent.std, outs["latent_post_std"], FULL_HEADS),
    ]


# goldens held, in the order the modules build on each other; (case, extra runner kwargs)
MODEL_CASES = [
    ("mlp_ln", {}), ("mlp_plain", {}),
    ("input_encoder_cat", {}), ("input_encoder_add", {}),
    ("polyline_encoder", {}),
    ("attn_knn", {}), ("attn_rpe", {}),
    ("attn_dense_self", {}), ("attn_dense_cross", {}),
    ("tfblock_enc_self_knn", {"dense_knn_max": 128}), ("tfblock_enc_self_knn", {"dense_knn_max": 0}),
    ("tfblock_enc_cross", {}), ("tfblock_dec_cross", {}), ("tfblock_dec_cross", {"dense_knn_max": 0}),
    ("tfblock_dense_self", {}),
    ("action_head_branch", {}), ("action_head_mlp_std", {}), ("add_navi_cat", {}), ("add_navi_add", {}),
    ("add_navi_mul", {}),
    ("dist_enc_diag_gaus", {}), ("dist_enc_diag_gaus_branch", {}),
    ("tl_predictor_hptr", {}), ("gru_seq", {}), ("gru_step", {}),
    ("navi_pred_cmd_hptr", {}), ("navi_pred_goal_rnn", {}),
    ("attn_rpe_q", {}), ("dist_enc_cat_branch", {}), ("dist_enc_cat_plain", {}), ("dist_enc_std_cat", {}),
    ("input_encoder_input", {}), ("tl_encoder_stacked", {}), ("tl_encoder_stacked", {"dense_knn_max": 0}),
]
# the goldens a KNARPE kernel runs with use_pallas=True: case -> (runner kwargs, kernel launches by name)
KERNEL_CASES = {
    "attn_rpe": ({}, {"knarpe_cross_attention": 1}),
    "tfblock_enc_cross": ({}, {"knarpe_cross_attention": 2}),
    "tfblock_dec_cross": ({"dense_knn_max": 0}, {"knarpe_cross_attention": 2, "knarpe_attention": 2}),
    "tfblock_enc_self_knn": ({"dense_knn_max": 0}, {"knarpe_attention": 2}),
    # 2 layers each: B4 in the map encoder and in the decoder self-attention of the agent encoder and of
    # the posterior TL and agent encoders; B2 in the agent encoder and the posterior TL and agent encoders
    # (the main TL encoder attends over static K/V)
    "traffic_bots_full": ({"dense_knn_max": 0}, {"knarpe_attention": 8, "knarpe_cross_attention": 6}),
    # 2 layers each: B4 in the map encoder, in tf_ag2ag at each of the 11 steps and in the posterior's; B2 in
    # tf_ag2mp and tf_ag2tl at each step and in the posterior's
    "traffic_bots_rnn": ({"dense_knn_max": 0}, {"knarpe_attention": 2 + 22 + 2, "knarpe_cross_attention": 44 + 4}),
    # the goal / cmd navi predictor's tf_ag2mp: B2 once per layer (2), over the K = 32 nearest map polylines
    "navi_pred_cmd_hptr": ({}, {"knarpe_cross_attention": 2}),
    "navi_pred_goal_rnn": ({}, {"knarpe_cross_attention": 2}),
    # no entry for attn_rpe_q (apply_q_rpe takes no kernel, as in the JAX package) or tl_encoder_stacked (the main
    # TL encoder attends over its static K/V and static decoder RPE, which no kernel takes)
}


def run_case(case: str, device="cpu", use_pallas=False, dense_knn_max=128) -> List[Check]:
    return globals()[f"run_{case}"](device=device, use_pallas=use_pallas, dense_knn_max=dense_knn_max)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(TORCH_THREADS)


def _case_id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


# use_pallas changes the path only where a block attends: there the KNARPE wrappers take their plain versions
ATTENDING = [case for case in MODEL_CASES if case[0].startswith(("attn_", "tfblock_", "navi_pred_"))]


@pytest.mark.parametrize("use_pallas,case", [(False, c) for c in MODEL_CASES] + [(True, c) for c in ATTENDING],
                         ids=lambda v: {False: "plain", True: "pallas"}[v] if isinstance(v, bool) else _case_id(v))
def test_model_golden(case, use_pallas):
    name, kw = case
    assert_checks(run_case(name, use_pallas=use_pallas, **kw))


@pytest.fixture(scope="module")
def full_checks():
    return {p: {c.name: c for c in run_traffic_bots_full(use_pallas=p, dense_knn_max=128 if not p else 0)}
            for p in (False, True)}


FULL_STAGES = ["mp_token_invalid", "mp_token_feature", "tl_token_attr", "action_mean", "action_std", "tl_log_probs",
               "navi_probs", "latent_post_mean", "latent_post_std"]


@pytest.mark.parametrize("stage", FULL_STAGES)
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
def test_traffic_bots_full_golden(full_checks, stage, use_pallas):
    """The whole model at each stage (not slow: the port compiles nothing)."""
    full_checks[use_pallas][stage].assert_ok()


@pytest.fixture(scope="module")
def rnn_checks():
    return {p: {c.name: c for c in run_traffic_bots_rnn(use_pallas=p, dense_knn_max=128 if not p else 0)}
            for p in (False, True)}


RNN_STAGES = ["action_mean", "action_std", "tl_log_probs", "rnn_hidden", "tl_rnn_hidden", "navi_probs",
              "latent_post_mean", "latent_post_std"]


@pytest.mark.parametrize("stage", RNN_STAGES)
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
def test_traffic_bots_rnn_golden(rnn_checks, stage, use_pallas):
    """The RNN family at each stage, 11 steps with the hiddens carried (use_pallas at dense_knn_max 0: the map
    and agent self-attentions on B4's plain version, the agent cross-attentions on B2's)."""
    rnn_checks[use_pallas][stage].assert_ok()


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_cases_reach_each_wrapper_as_the_layers_say(case, monkeypatch):
    """The calls of each KNARPE wrapper that `chip_smoke.py` expects as kernel launches on the card."""
    from trafficbotsv15_tpu_torch.ops import knarpe

    calls = {}
    for name in ("knarpe_attention", "knarpe_cross_attention"):
        def counted(*args, _fn=getattr(knarpe, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(knarpe, name, counted)
    kw, launches = KERNEL_CASES[case]
    assert_checks(run_case(case, use_pallas=True, **kw))
    assert calls == launches


def test_reference_layout_gives_the_golden_state_dict():
    """The inverse of the mapping, at traffic_bots_full's config: the golden's 526 keys and shapes, and its
    values bit for bit but for the prior encoders that the reference builds and never runs (zeros)."""
    from torch_reference_layout import reference_state_dict

    sd, _, _, _ = load_golden("model", "traffic_bots_full")
    model = full_model("traffic_bots_full", "cpu")[0]
    exported = reference_state_dict(model)
    assert len(sd) == 526 and set(exported) == set(sd)
    assert {k: v.shape for k, v in exported.items()} == {k: v.shape for k, v in sd.items()}
    idle = tuple(ti.idle_reference_prefixes(model.cfg))
    differ = [k for k in sd if not np.array_equal(exported[k], sd[k]) and not k.startswith(idle)]
    assert not differ, differ[:8]


def test_reference_layout_round_trips_at_the_flagship_config():
    """leaderboard_config's model (hidden 128, 8/4/4 layers, its own MLP dropout slots) exported to the reference
    layout and loaded back: every parameter bit for bit."""
    from torch_reference_layout import reference_state_dict
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = pc.leaderboard_config()
    src, dst = build_model(cfg, seed=0, device="cpu"), build_model(cfg, seed=1, device="cpu")
    ti.load_reference_state_dict(dst, reference_state_dict(src, cfg.data), cfg.model, cfg.time_step_gt)
    want = src.state_dict()
    assert all(torch.equal(v.view(torch.int32), want[k].view(torch.int32)) for k, v in dst.state_dict().items())


def test_check_excess_reads_the_tolerance():
    want = np.array([1.0, -2.0])
    assert Check("x", want + 1e-5, want, 1e-5, 0.0).excess() <= 1e-12
    assert Check("x", want + 3e-5, want, 1e-5, 0.0).excess() == pytest.approx(2e-5)
    assert Check("x", np.array([np.nan, 0.0]), want, 1.0).excess() == float("inf")
    assert Check("x", want[:1], want, 1.0).excess() == float("inf")
    assert Check("b", np.array([True]), np.array([True])).excess() == 0.0
