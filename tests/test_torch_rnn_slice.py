"""PyTorch port: the TrafficBots RNN family's `joint_future_pred` (tiny_config, temp_window_size=0) against the JAX
package, with use_pallas False at check_level 0 and with use_pallas True (dense_knn_max 4: the map and the
agent self-attentions through B4's wrapper, the agent cross-attentions through B2's; on the CPU both packages
take their plain versions) at the default check_level 1.

One module-scoped fixture per arm (`torch_rnn_common.run_joint_future`) runs the JAX `joint_future_pred` once under
jit (KNN on the stable sort, K0 futures deterministic) with its rollout's arguments captured, and the port's:
  - the K0 rows, whose latent and destination are the modes, must match;
  - the port's rollout replayed with the JAX-sampled latents and destinations must match in every row.
TL runs inside the rollout (the RNN state predictor carries a GRU hidden), forced to the log over the
11 logged steps and free after them; the agent encoder's GRU hidden rides in the carry. Tolerances in
`tests/torch_rnn_common.py`.
"""

import pytest
import torch

from torch_rnn_common import K, K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows, count_wrappers, rnn_cfg, \
    run_joint_future

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "pallas"])
def run(request):
    return run_joint_future(rnn_cfg(use_pallas=request.param), check_level=1 if request.param else 0)


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_rnn_joint_future_pred_k0_rows(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_rnn_rollout_with_injected_samples_every_row(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_rnn_rollout_with_injected_samples_rule_flags(run):
    assert_flags(run["jroll"], run["injected"])


def test_rnn_joint_future_pred_k0_rule_flags(run):
    assert_flags(run["jbuf"], run["pbuf"], k0_only=True)


def test_rnn_joint_future_pred_outputs(run):
    buf, cfg = run["pbuf"], run["cfg"]
    n_step = cfg.time_step_end
    assert tuple(buf.pred_pose.shape) == (2, K, cfg.data.n_ag, n_step, 3)
    assert tuple(buf.tl_state.shape) == (2, K, cfg.data.n_tl_lane, n_step, 5)
    assert torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    # TL forced to the log over its 11 steps (rollout steps 1-10), then free: the NLL masked off past it
    assert not buf.tl_state_nll_invalid[..., : cfg.n_step_hist - 1].all()
    assert buf.tl_state_nll_invalid[..., cfg.n_step_hist - 1:].all()


def test_rnn_kernel_wrappers_once_per_layer_and_step(monkeypatch):
    """With 512 polylines the agent->map KNN passes the kernel gate: one KNN wrapper call per rollout step at
    [n_sc * K, n_ag, 512], k = 2 * n_tgt_knn; with use_pallas (dense_knn_max 4) B4 once per map layer and per
    tf_ag2ag layer and step, B2 once per tf_ag2mp and tf_ag2tl layer and step (ag2mp K=8, ag2tl K=3)."""
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from test_torch_helpers import port_cfg
    from trafficbotsv15_tpu.config import tiny_config

    cfg = port_cfg(rnn_cfg(use_pallas=True, data=tiny_config(n_mp=512).data))
    model = build_model(cfg, seed=0, device="cpu")
    calls = count_wrappers(monkeypatch)
    _, buf = port_eval.joint_future_pred(cfg, model, make_batch(cfg.data, n_sc=1, seed=0),
                                         generator=torch.Generator().manual_seed(0), n_joint_future=K, device="cpu")
    n_step, n_ag, d, n_layer = cfg.time_step_end, cfg.data.n_ag, cfg.model.hidden_dim, cfg.model.ag_encoder.n_layer_tf
    assert calls["knn_xy"] == [(K, n_ag, 2, 512, 8)] * n_step
    assert calls["knarpe_attention"] == ([(1, 512, d, cfg.model.n_tgt_knn)] * cfg.model.mp_encoder.n_layer_tf
                                         + [(K, n_ag, d, 3)] * n_layer * n_step)
    assert calls["knarpe_cross_attention"] == ([(K, n_ag, d, 8)] * n_layer + [(K, n_ag, d, 3)] * n_layer) * n_step
    assert torch.isfinite(buf.pred_pose).all()
