"""PyTorch port: `joint_future_pred` of the scene-centric model (`pairwise_relative=False`) and of the last transformer
and pooling options against the JAX package, on the CPU.

The arms (`tiny_config()` at gain 0.5, K0 futures deterministic; `tests/torch_navi_common.py::run_joint_future` runs
JAX's call under `jax.jit` with its rollout's draws captured and injected into the port's rollout):
  - `dest`: scene-centric, lane TL tokens, dest navi;
  - `goal_stop`: scene-centric, stop-line TL tokens (their pose embedded), goal navi, use_pallas at dense_knn_max 4;
  - `cmd`: scene-centric, cmd navi;
  - `rnn`: the scene-centric TrafficBots RNN family (pose embeddings into its input encoders), use_pallas, its
    latent pooled by `last`;
  - `options`: the pairwise model with gelu FFNs, `mean_valid` polyline pooling and dropout on the attention
    weights (p = 0.1; evaluation draws no mask), use_pallas at dense_knn_max 4;
  - `elu_first`: scene-centric with elu FFNs and `first` polyline pooling.
Held at `tests/torch_rnn_common.py`'s tolerances: the K0 rows of the port's own call and every row of the rollout with
JAX's draws injected; rule flags equal.

Then the kernels: the scene-centric model calls no kernel wrapper with use_pallas, as JAX's gates say, where the
pairwise model at the same config calls B4, B2 and, at 512 polylines, the KNN select; dropout on the attention
weights turns B4 and B2 off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import port_cfg, set_threads
from torch_navi_common import K, navi_cfg, run_joint_future
from torch_rnn_common import K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows, count_wrappers, rnn_cfg
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch

set_threads()


def _model(cfg, pairwise=False, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pairwise_relative=pairwise, **kw))


def arm_cfg(name: str):
    """The JAX config of an arm (see the module docstring)."""
    if name == "dest":
        return _model(navi_cfg("dest"))
    if name == "goal_stop":
        return _model(navi_cfg("goal", use_pallas=True), tl_mode="stop")
    if name == "cmd":
        return _model(navi_cfg("cmd"))
    if name == "rnn":
        cfg = rnn_cfg(use_pallas=True)
        return _model(cfg, ag_encoder=dataclasses.replace(cfg.model.ag_encoder, rnn_latent_temp_pool_mode="last"))
    m = navi_cfg("dest", use_pallas=True).model
    if name == "options":
        tf = dataclasses.replace(m.tf_cfg, activation="gelu", attn_dropout_weights=True, dropout_p=0.1)
        pl = dataclasses.replace(m.mp_encoder.pl_encoder, pooling_mode="mean_valid")
        return _model(navi_cfg("dest", use_pallas=True), pairwise=True, tf_cfg=tf,
                      mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=pl))
    if name == "elu_first":
        pl = dataclasses.replace(m.mp_encoder.pl_encoder, pooling_mode="first")
        return _model(navi_cfg("dest"), tf_cfg=dataclasses.replace(navi_cfg("dest").model.tf_cfg, activation="elu"),
                      mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=pl))
    raise ValueError(name)


ARMS = ("dest", "goal_stop", "cmd", "rnn", "options", "elu_first")


@pytest.fixture(scope="module", params=ARMS)
def run(request):
    return run_joint_future(arm_cfg(request.param))


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_joint_future_pred_k0_rows_match_jax(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_rollout_with_injected_samples_every_row_matches_jax(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_rollout_rule_flags_match_jax(run):
    assert_flags(run["jroll"], run["injected"])
    assert_flags(run["jbuf"], run["pbuf"], k0_only=True)


@pytest.mark.parametrize("pairwise", [True, False], ids=["pairwise", "scene_centric"])
def test_scene_centric_model_calls_no_kernel(pairwise, monkeypatch):
    """use_pallas at dense_knn_max 4, 512 polylines (the KNN select's gate: n_tgt >= 512): the pairwise model calls
    the KNN select once per step, B4 per map layer and per agent layer and step, B2 per agent layer and step; the
    scene-centric one none of them, as JAX's gates say (its KNN sorts, its attentions take no RPE)."""
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = tiny_config(n_mp=512)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pairwise_relative=pairwise, tf_cfg=(
        dataclasses.replace(cfg.model.tf_cfg, use_pallas=True, dense_knn_max=4))))
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, seed=0, device="cpu")
    calls = count_wrappers(monkeypatch)
    _, buf = port_eval.joint_future_pred(pcfg, model, make_batch(pcfg.data, n_sc=1, seed=0),
                                         generator=torch.Generator().manual_seed(0), n_joint_future=K, device="cpu")
    assert torch.isfinite(buf.pred_pose).all()
    n, m = pcfg.time_step_end, pcfg.model
    if pairwise:
        assert len(calls["knn_xy"]) == n
        assert len(calls["knarpe_attention"]) == m.mp_encoder.n_layer_tf + m.ag_encoder.n_layer_tf * n
        assert len(calls["knarpe_cross_attention"]) == m.ag_encoder.n_layer_tf * n
    else:
        assert not any(calls.values()), {k: len(v) for k, v in calls.items()}


def test_attn_dropout_weights_turns_the_kernels_off(monkeypatch):
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    pcfg = port_cfg(arm_cfg("options"))
    model = build_model(pcfg, seed=0, device="cpu")
    calls = count_wrappers(monkeypatch)
    port_eval.joint_future_pred(pcfg, model, make_batch(pcfg.data, n_sc=1, seed=0),
                                generator=torch.Generator().manual_seed(0), n_joint_future=K, device="cpu")
    assert not calls["knarpe_attention"] and not calls["knarpe_cross_attention"]
    assert all(not layer.attn.use_pallas for layer in model.ag_encoder.tf_ag2agmptl.layers())
    assert np.isclose(pcfg.model.tf_cfg.dropout_p, 0.1) and pcfg.model.tf_cfg.use_pallas
