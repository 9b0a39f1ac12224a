"""PyTorch port: navi re-prediction inside the rollout (`pred_navi_after_reached`, goal and dest modes) against the
JAX package, with JAX's per-step navi noise injected (`tests/torch_navi_common.py`).

Reactive replay (check_level 1) and the K-future rollout of `joint_future_pred` (K0 deterministic; the draws the
rollout starts from injected too), at batches where the seed-0 weights reach goals and destinations: every row
of the buffer, the rule flags, and the buffer's navi log-probs, now [.., 1 + n_step] (the initial navi's, then
each step's draw where an agent re-predicted) as JAX's `tests/test_rollout_train.py::test_navi_reprediction_rollout`
asserts, to 1e-4 each, which holds the predictor's mean (goal) or logits (dest) inside every step that fires. The
tests count the re-predictions and need more than 0. The joint-future scores (`log_prob`) that sum these log-probs
agree too.
"""

import pytest
import torch

from test_torch_helpers import t2n
from torch_navi_common import K, REPREDICT_BATCH_SEED, navi_cfg, run_joint_future, run_reactive_replay
from torch_rnn_common import ROW_FIELDS, assert_flags, assert_rows

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["goal", "dest"])
def replay(request):
    return run_reactive_replay(navi_cfg(request.param, repredict=True),
                               batch_seed=REPREDICT_BATCH_SEED["replay"][request.param])


@pytest.fixture(scope="module", params=["goal", "dest"])
def futures(request):
    return run_joint_future(navi_cfg(request.param, repredict=True),
                            batch_seed=REPREDICT_BATCH_SEED["futures"][request.param])


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_reactive_replay_with_reprediction_matches_jax(replay, field, atol):
    want, got = replay
    assert_rows(want["buffer"], got["buffer"], field, atol)


def test_reactive_replay_reprediction_fires_and_flags_match(replay):
    want, got = replay
    assert_flags(want["buffer"], got["buffer"])
    buf = got["buffer"]
    n_step = buf.pred_pose.shape[2]
    assert tuple(buf.navi_log_prob.shape) == tuple(buf.navi_log_prob_valid.shape) == (*buf.pred_valid.shape[:2],
                                                                                      1 + n_step)
    assert int(buf.navi_log_prob_valid[..., 1:].sum()) > 0, "no agent reached its navi: nothing was re-predicted"
    assert torch.isfinite(buf.navi_log_prob).all()


def test_reactive_replay_loss_with_reprediction_matches_jax(replay):
    want, got = replay
    assert set(got["loss"]) == set(want["loss"])
    for k, v in want["loss"].items():
        assert abs(float(got["loss"][k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1.0), k


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_joint_future_rollout_with_reprediction_matches_jax(futures, field, atol):
    assert_rows(futures["jroll"], futures["injected"], field, atol)


def test_joint_future_navi_scores_match_jax(futures):
    """The navi part of the joint-future scores: the mean of each row's valid navi log-probs, over 1 + n_step."""
    import numpy as np
    from trafficbotsv15_tpu_torch.sim.rollout import compute_log_prob

    jbuf = futures["jroll"]
    lp, valid = np.asarray(jbuf.navi_log_prob), np.asarray(jbuf.navi_log_prob_valid)
    want = (lp * valid).sum(-1) / np.maximum(valid.sum(-1), 1)
    got = compute_log_prob(futures["injected"], None).log_prob
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-4)


def test_joint_future_reprediction_fires_and_flags_match(futures):
    assert_flags(futures["jroll"], futures["injected"])
    buf = futures["injected"]
    n_step = buf.pred_pose.shape[2]
    assert tuple(buf.navi_log_prob.shape) == (2 * K, buf.pred_pose.shape[1], 1 + n_step)
    assert int(buf.navi_log_prob_valid[..., 1:].sum()) > 0, "no agent reached its navi: nothing was re-predicted"
    pbuf = futures["pbuf"]  # the port's own draws: the same shapes, finite
    assert tuple(pbuf.navi_log_prob.shape) == (2, K, buf.pred_pose.shape[1], 1 + n_step)
    assert torch.isfinite(pbuf.log_prob).all() and torch.isfinite(pbuf.pred_pose).all()


def test_reprediction_needs_its_inputs():
    """Without the map arrays, or without draws, the re-predicting rollout raises; cmd mode does not re-predict."""
    from test_torch_helpers import port_cfg
    from trafficbotsv15_tpu_torch.sim.rollout import _repredict_draw, navi_draws, repredicts

    cfg = port_cfg(navi_cfg("goal", repredict=True))
    draw = navi_draws(noise=[torch.zeros(1)])
    with pytest.raises(ValueError, match="map arrays"):
        _repredict_draw(cfg, None, draw)
    with pytest.raises(ValueError, match="generator or navi_noise"):
        _repredict_draw(cfg, {}, None)
    with pytest.raises(ValueError, match="steps"):
        _repredict_draw(cfg, {}, draw)(None, 1)
    assert _repredict_draw(cfg, {}, draw) is draw
    assert not repredicts(port_cfg(navi_cfg("cmd", repredict=True)))
    assert _repredict_draw(port_cfg(navi_cfg("cmd", repredict=True)), None, None) is None
