"""PyTorch port: `joint_future_pred` in the goal, cmd and dummy navigation modes (tiny_config) against the JAX
package, on the deterministic path: the K0 rows, whose latent and navi are the modes, and every row of the port's
rollout replayed with JAX's latent and navi draws (`tests/torch_navi_common.py`: configs, the cmd draw as its
one-hot, tolerances). The arms: goal with use_pallas False at check_level 0, goal with use_pallas (the navi
predictor's tf_ag2mp through B2's wrapper) at level 1, cmd with AddNaviLatent `add` at level 1, dummy with
AddNaviLatent `mul` (which the dummy navi skips; the latent fuses by `mul`) and use_pallas at level 1.
"""

import pytest
import torch

from torch_navi_common import K, navi_cfg, run_joint_future
from torch_rnn_common import K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows

torch.set_num_threads(2)

ARMS = {"goal-plain": (dict(navi_mode="goal"), 0), "goal-pallas": (dict(navi_mode="goal", use_pallas=True), 1),
        "cmd-add": (dict(navi_mode="cmd", add_mode="add"), 1),
        "dummy-mul-pallas": (dict(navi_mode="dummy", add_mode="mul", use_pallas=True), 1)}


@pytest.fixture(scope="module", params=sorted(ARMS))
def run(request):
    kw, level = ARMS[request.param]
    return run_joint_future(navi_cfg(**kw), check_level=level)


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_navi_joint_future_pred_k0_rows(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_navi_rollout_with_injected_samples_every_row(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_navi_rollout_rule_flags(run):
    assert_flags(run["jroll"], run["injected"])
    assert_flags(run["jbuf"], run["pbuf"], k0_only=True)


def test_navi_joint_future_samples(run):
    """The navi each future rolls out with: a goal [n_sc * K, n_ag, 4], a command's one-hot [.., n_ag_cmd] (bool),
    none in dummy mode (its log-prob 0 and invalid); the buffer's navi log-prob [.., 1] (no re-prediction)."""
    cfg, buf, s = run["cfg"], run["pbuf"], run["samples"]
    n, n_ag = 2 * K, cfg.data.n_ag
    mode = cfg.model.navi_mode
    if mode == "dummy":
        assert s["ag_navi"] is None and not s["ag_navi_valid"].any() and not s["ag_navi_log_prob"].any()
    elif mode == "goal":
        assert tuple(s["ag_navi"].shape) == (n, n_ag, 4)
    else:
        assert s["ag_navi"].dtype == torch.bool and tuple(s["ag_navi"].shape) == (n, n_ag, cfg.data.n_ag_cmd)
        assert (s["ag_navi"].sum(-1) == 1).all()
    assert tuple(buf.navi_log_prob.shape) == (2, K, n_ag, 1) and torch.isfinite(buf.log_prob).all()


def test_navi_predictor_b2_once_per_layer(monkeypatch):
    """In goal mode with use_pallas the navi predictor runs once per call, before the futures replicate: B2 once per
    tf_ag2mp layer at [n_sc, n_ag, K = n_tgt_knn * k_tgt_knn], beside the agent decoder's per step."""
    from test_torch_helpers import port_cfg
    from torch_rnn_common import count_wrappers
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = port_cfg(navi_cfg("goal", use_pallas=True))
    model = build_model(cfg, seed=0, device="cpu")
    calls = count_wrappers(monkeypatch)
    port_eval.joint_future_pred(cfg, model, make_batch(cfg.data, n_sc=1, seed=0),
                                generator=torch.Generator().manual_seed(0), n_joint_future=K, device="cpu")
    m = cfg.model
    navi_shape = (1, cfg.data.n_ag, m.hidden_dim, int(m.n_tgt_knn * m.navi_predictor.k_tgt_knn))
    assert calls["knarpe_cross_attention"].count(navi_shape) == m.navi_predictor.n_layer_tf
    assert len(calls["knarpe_cross_attention"]) == m.navi_predictor.n_layer_tf + m.ag_encoder.n_layer_tf * \
        cfg.time_step_end
