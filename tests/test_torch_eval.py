"""PyTorch port: the eval modules against the JAX package on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and the
port's counterpart:
  - `eval/metrics.py`: the error and rule sums and their normalisation, also
    against the reference's golden (`tests/golden/sim/logging_metrics.npz`);
  - `eval/womd_post_processing.py`: top-k, MTR-NMS, EM aggregation, MPA-NMS
    and the score temperature, an all-ties case and a one-mode case;
  - `eval/womd_metrics.py::native_motion_metrics`, at the flagship's 16
    samples and at a short horizon;
  - `eval/wosac_post_processing.py`: `filter_futures` at K=40 with tied
    violation counts, `to_global_frame`, `build_wosac_data`;
    `ops/transform.py::pos2global`, `rad2global`;
  - `sim/rule_checker.py::build_road_edges`, bit-exact.
Tolerance: 1e-5 relative on float outputs (summation order; softmax and
norms of another library), with 1e-6 absolute for values near zero.
Selections (the modes and futures kept, hence their trajectories), counts
and flags are exact.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_golden_model import load_golden
from test_torch_helpers import set_threads
from trafficbotsv15_tpu.config import WOMDPostCfg as JaxWOMDPostCfg
from trafficbotsv15_tpu.config import WOSACPostCfg as JaxWOSACPostCfg
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import metrics as jm
from trafficbotsv15_tpu.eval import womd_metrics as jwm
from trafficbotsv15_tpu.eval import womd_post_processing as jwp
from trafficbotsv15_tpu.eval import wosac_post_processing as jws
from trafficbotsv15_tpu.ops import transform as jtr
from trafficbotsv15_tpu.sim import rule_checker as jrc
from trafficbotsv15_tpu_torch.config import WOMDPostCfg, WOSACPostCfg
from trafficbotsv15_tpu_torch.eval import metrics as pm
from trafficbotsv15_tpu_torch.eval import womd_metrics as pwm
from trafficbotsv15_tpu_torch.eval import womd_post_processing as pwp
from trafficbotsv15_tpu_torch.eval import wosac_post_processing as pws
from trafficbotsv15_tpu_torch.ops import transform as ptr
from trafficbotsv15_tpu_torch.sim import rule_checker as prc

set_threads()
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _rollout_arrays(rng, n_sc=3, k=4, n_ag=6, n_step=20):
    """A flattened buffer's arrays [n_sc, K, n_ag, n_step, ...], ground truth from step 0 and agent types."""
    return dict(
        pred_valid=rng.uniform(size=(n_sc, k, n_ag, n_step)) < 0.8,
        pred_pose=(rng.normal(size=(n_sc, k, n_ag, n_step, 3)) * [20, 20, 2]).astype(np.float32),
        pred_motion=rng.normal(size=(n_sc, k, n_ag, n_step, 3)).astype(np.float32),
        violation={key: rng.uniform(size=(n_sc, k, n_ag, n_step)) < 0.05 for key in
                   ("outside_map", "collided", "collided_wosac", "run_road_edge", "run_red_light", "passive",
                    "goal_reached", "dest_reached")},
        gt_valid=rng.uniform(size=(n_sc, n_ag, n_step + 5)) < 0.8,
        gt_pose=(rng.normal(size=(n_sc, n_ag, n_step + 5, 3)) * [20, 20, 2]).astype(np.float32),
        gt_motion=rng.normal(size=(n_sc, n_ag, n_step + 5, 3)).astype(np.float32),
        ag_type=np.eye(3, dtype=bool)[rng.integers(0, 3, size=(n_sc, n_ag))],
    )


def _buffers(a, k_slice=slice(None)):
    fields = ("pred_valid", "pred_pose", "pred_motion")
    jbuf = types.SimpleNamespace(**{f: jnp.asarray(a[f][:, k_slice]) for f in fields},
                                 violation={k: jnp.asarray(v[:, k_slice]) for k, v in a["violation"].items()})
    pbuf = types.SimpleNamespace(**{f: _t(a[f][:, k_slice]) for f in fields},
                                 violation={k: _t(v[:, k_slice]) for k, v in a["violation"].items()})
    return jbuf, pbuf


@pytest.mark.parametrize("step_start", [1, 3])
def test_error_metric_sums_match_jax(step_start):
    a = _rollout_arrays(np.random.default_rng(step_start))
    jbuf, pbuf = _buffers(a, slice(0, 1))
    want = jm.error_metric_sums(jbuf, *(jnp.asarray(a[k]) for k in ("gt_valid", "gt_pose", "gt_motion")),
                                step_start=step_start)
    got = pm.error_metric_sums(pbuf, *(_t(a[k]) for k in ("gt_valid", "gt_pose", "gt_motion")), step_start=step_start)
    assert set(got) == set(want) and all(v.ndim == 0 for v in got.values())
    assert float(got["err_counter"]) == float(want["err_counter"])
    for key in want:
        _close(got[key], want[key], msg=key)
    got_m, want_m = pm.compute_error_metrics(got, "rr"), jm.compute_error_metrics(want, "rr")
    assert set(got_m) == set(want_m)
    for key in want_m:
        _close(got_m[key], want_m[key], msg=key)


def test_traffic_rule_sums_match_jax():
    a = _rollout_arrays(np.random.default_rng(7))
    jbuf, pbuf = _buffers(a)
    want = jm.traffic_rule_sums(jbuf, jnp.asarray(a["ag_type"]))
    got = pm.traffic_rule_sums(pbuf, _t(a["ag_type"]))
    assert set(got) == set(want)
    for key in want:  # counts: exact
        assert float(got[key]) == float(want[key]), key
    merged_p, merged_j = pm.merge_sums(pm.merge_sums({}, got), got), jm.merge_sums(jm.merge_sums({}, want), want)
    assert pm.compute_traffic_rule_metrics(merged_p, "jf") == jm.compute_traffic_rule_metrics(merged_j, "jf")


def test_logging_metrics_match_golden():
    """The reference's ErrorMetrics / TrafficRuleMetrics over two batches, as `test_sim_parity.py` holds the
    JAX package to it, with its tolerance."""
    _, ins, outs, meta = load_golden("sim", "logging_metrics")
    err_sums, tr_sums = {}, {}
    for i in range(meta["n_batches"]):
        b = {k[len(f"b{i}_"):]: v for k, v in ins.items() if k.startswith(f"b{i}_")}
        buf1 = types.SimpleNamespace(pred_valid=_t(b["pred_valid1"]), pred_pose=_t(b["pred_pose1"]),
                                     pred_motion=_t(b["pred_motion1"]))
        err_sums = pm.merge_sums(err_sums, pm.error_metric_sums(buf1, _t(b["gt_valid"]), _t(b["gt_pose"]),
                                                                _t(b["gt_motion"]), step_start=meta["step_start"]))
        buf_k = types.SimpleNamespace(pred_valid=_t(b["pred_validK"]),
                                      violation={k[5:]: _t(v) for k, v in b.items() if k.startswith("viol_")})
        tr_sums = pm.merge_sums(tr_sums, pm.traffic_rule_sums(buf_k, _t(b["ag_type"])))
    got = {**pm.compute_error_metrics(err_sums, "reactive_replay"),
           **pm.compute_traffic_rule_metrics(tr_sums, "reactive_replay")}
    assert len(outs) == 10
    for gk, want in outs.items():
        k = gk.replace("__", "/")
        np.testing.assert_allclose(got[k], float(want), rtol=1e-5, atol=1e-7, err_msg=k)


# WOMD post-processing variants: (config overrides, K, scores given)
WOMD_CASES = {
    "topk": (dict(mpa_nms_thresh=()), 12, True),
    "mtr": (dict(mtr_nms_thresh=(2.0, 1.0, 1.5), mpa_nms_thresh=()), 12, True),
    "aggr": (dict(aggr_thresh=(2.5,), n_iter_em=3, mpa_nms_thresh=()), 12, True),
    "mpa": (dict(), 12, True),
    "mtr_mpa_temperature": (dict(mtr_nms_thresh=(2.0, 1.0, 1.5), score_temperature=0.5), 12, True),
    "all_ties": (dict(), 12, False),
    "k1": (dict(), 1, True),
}


def _womd_inputs(seed, k, n_sc=2, n_ag=5, n_step=20):
    """Futures that cluster (modes within the NMS thresholds of one another) and log-prob scores."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(n_sc, 1, n_ag, n_step, 3)) * [1.0, 1.0, 0.05], 3)
    trajs = (base + rng.normal(size=(n_sc, k, n_ag, 1, 3)) * [2.0, 2.0, 0.1]
             + rng.normal(size=(n_sc, k, n_ag, n_step, 3)) * 0.1).astype(np.float32)
    scores = rng.normal(size=(n_sc, k, n_ag)).astype(np.float32)
    ag_type = np.eye(3, dtype=bool)[rng.integers(0, 3, size=(n_sc, n_ag))]
    return trajs, scores, ag_type


@pytest.mark.parametrize("case", list(WOMD_CASES))
def test_womd_post_process_matches_jax(case):
    overrides, k, with_scores = WOMD_CASES[case]
    trajs, scores, ag_type = _womd_inputs(3, k)
    jcfg = dataclasses.replace(JaxWOMDPostCfg(), **overrides)
    pcfg = dataclasses.replace(WOMDPostCfg(), **overrides)
    want = jwp.womd_post_process(jcfg, jnp.asarray(ag_type), jnp.asarray(trajs),
                                 jnp.asarray(scores) if with_scores else None, track_future_samples=20)
    got = pwp.womd_post_process(pcfg, _t(ag_type), _t(trajs), _t(scores) if with_scores else None,
                                track_future_samples=20)
    assert got["trajs"].shape == want["trajs"].shape == (2, 5, min(k, 6), 4, 3)
    if case == "aggr":  # cluster means, the same numpy code on both sides over the same assignment
        _close(got["trajs"], want["trajs"], msg="trajs")
    else:  # the selected modes, in the same order
        np.testing.assert_array_equal(got["trajs"].numpy(), np.asarray(want["trajs"]))
    _close(got["scores"], want["scores"], msg="scores")


def test_womd_post_process_suppresses_and_ties():
    """The cases above take the branches they name: MTR-NMS and MPA-NMS change the top-k choice, and with
    every score tied the first k_pred modes are kept in order, as jax.lax.top_k keeps them."""
    trajs, scores, ag_type = _womd_inputs(3, 12)
    topk = pwp.womd_post_process(WOMDPostCfg(mpa_nms_thresh=()), _t(ag_type), _t(trajs), _t(scores), 20)
    mtr = pwp.womd_post_process(WOMDPostCfg(mtr_nms_thresh=(2.0, 1.0, 1.5), mpa_nms_thresh=()), _t(ag_type),
                                _t(trajs), _t(scores), 20)
    mpa = pwp.womd_post_process(WOMDPostCfg(), _t(ag_type), _t(trajs), _t(scores), 20)
    assert not torch.equal(topk["trajs"], mtr["trajs"])
    assert not torch.allclose(topk["scores"], mpa["scores"])
    ties = pwp.womd_post_process(WOMDPostCfg(mpa_nms_thresh=()), _t(ag_type), _t(trajs), None, 20)
    np.testing.assert_array_equal(ties["trajs"].numpy(), trajs.swapaxes(1, 2)[:, :, :6, 4:20:5])


@pytest.mark.parametrize("n_step_pred", [16, 2])
def test_native_motion_metrics_match_jax(n_step_pred):
    rng = np.random.default_rng(n_step_pred)
    n_sc, n_ag, k, n_gt = 2, 7, 6, 11 + 5 * n_step_pred
    gt_pos = np.cumsum(rng.normal(size=(n_sc, n_ag, n_gt, 2)), 2).astype(np.float32)
    steps = 10 + 5 * (np.arange(n_step_pred) + 1)
    trajs = (gt_pos[:, :, None, steps] + rng.normal(size=(n_sc, n_ag, k, n_step_pred, 2)) * 2.0).astype(np.float32)
    trajs = np.concatenate([trajs, np.zeros_like(trajs[..., :1])], -1)
    args = dict(trajs=trajs, scores=rng.uniform(size=(n_sc, n_ag, k)).astype(np.float32), gt_pos=gt_pos,
                gt_yaw=rng.uniform(-3, 3, size=(n_sc, n_ag, n_gt)).astype(np.float32),
                gt_valid=rng.uniform(size=(n_sc, n_ag, n_gt)) < 0.85,
                gt_spd=rng.uniform(0, 15, size=(n_sc, n_ag, n_gt)).astype(np.float32),
                mask_pred=rng.uniform(size=(n_sc, n_ag)) < 0.7)
    want = jwm.native_motion_metrics(**{k: jnp.asarray(v) for k, v in args.items()}, step_current=10)
    got = pwm.native_motion_metrics(**{k: _t(v) for k, v in args.items()}, step_current=10)
    assert set(got) == set(want) and len(got) == (12 if n_step_pred == 16 else 6)
    for key in want:
        _close(got[key], want[key], msg=key)
    assert 0 < float(got["miss_rate"]) < 1  # neither all hits nor all misses


def _filter_inputs(k, seed=5, n_sc=2, n_ag=6, n_step=15):
    rng = np.random.default_rng(seed)
    a = dict(pred_pose=rng.normal(size=(n_sc, k, n_ag, n_step, 3)).astype(np.float32),
             violation={key: rng.uniform(size=(n_sc, k, n_ag, n_step)) < 0.01 for key in
                        ("collided", "collided_wosac", "run_road_edge")})
    role = rng.uniform(size=(n_sc, n_ag, 3)) < 0.4
    return a, role


@pytest.mark.parametrize("use_wosac_col,w_road_edge", [(True, 0.0), (False, 1.0), (True, 0.5)])
def test_filter_futures_matches_jax_with_ties(use_wosac_col, w_road_edge):
    a, role = _filter_inputs(40)
    jbuf = types.SimpleNamespace(pred_pose=jnp.asarray(a["pred_pose"]),
                                 violation={k: jnp.asarray(v) for k, v in a["violation"].items()})
    pbuf = types.SimpleNamespace(pred_pose=_t(a["pred_pose"]), violation={k: _t(v) for k, v in a["violation"].items()})
    want = jws.filter_futures(JaxWOSACPostCfg(w_road_edge=w_road_edge, use_wosac_col=use_wosac_col), jbuf,
                              jnp.asarray(role), 5)
    got = pws.filter_futures(WOSACPostCfg(w_road_edge=w_road_edge, use_wosac_col=use_wosac_col), pbuf, _t(role), 5)
    assert tuple(got.shape) == (2, 32, 6, 10, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the cut at 32 falls inside a tie: more than 32 futures share the kept ones' best count
    key = "collided_wosac" if use_wosac_col else "collided"
    counts = (a["violation"][key][..., 5:].any(-1) * role.any(-1)[:, None]).sum(-1)
    assert (counts == 0).sum(-1).max() > 8 and (counts > 0).any()


def test_filter_futures_keeps_all_at_most_32():
    a, role = _filter_inputs(8)
    pbuf = types.SimpleNamespace(pred_pose=_t(a["pred_pose"]), violation={k: _t(v) for k, v in a["violation"].items()})
    np.testing.assert_array_equal(pws.filter_futures(WOSACPostCfg(), pbuf, _t(role), 5).numpy(),
                                  a["pred_pose"][..., 5:, :])


def test_to_global_frame_and_transforms_match_jax():
    rng = np.random.default_rng(9)
    trajs = (rng.normal(size=(3, 4, 5, 6, 3)) * [50, 50, 3]).astype(np.float32)
    center = (rng.normal(size=(3, 2)) * 1000).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=3).astype(np.float32)
    want = jws.to_global_frame(jnp.asarray(trajs), jnp.asarray(center), jnp.asarray(yaw))
    got = pws.to_global_frame(_t(trajs), _t(center), _t(yaw))
    _close(got[..., :2], want[..., :2], atol=1e-3, msg="position (~1e3 m in float32)")
    _close(got[..., 2], want[..., 2], msg="yaw")
    pos = _t(trajs[:, 0, 0, :, :2])
    rot = ptr.rad2rot(_t(yaw))
    _close(ptr.pos2global(pos, _t(center)[:, None], rot),
           jtr.pos2global(jnp.asarray(pos.numpy()), jnp.asarray(center)[:, None], jtr.rad2rot(jnp.asarray(yaw))),
           atol=1e-3)
    _close(ptr.rad2global(_t(trajs[:, 0, 0, :, 2]), _t(yaw)),
           jtr.rad2global(jnp.asarray(trajs[:, 0, 0, :, 2]), jnp.asarray(yaw)))
    back = ptr.pos2local(ptr.pos2global(pos, _t(center)[:, None], rot), _t(center)[:, None], rot)
    _close(back, pos, atol=1e-3)


@pytest.mark.parametrize("segment_budget", [6144, 150, 40])
def test_build_road_edges_bit_exact(segment_budget):
    cfg = tiny_config()
    b = make_batch(cfg.data, n_sc=3, seed=4)
    args = [b["map/valid"], b["map/type"].astype(bool), b["map/pos"], b["map/dir"]]
    want_edge, want_valid = jrc.build_road_edges(*(jnp.asarray(x) for x in args), segment_budget)
    got_edge, got_valid = prc.build_road_edges(*(_t(x) for x in args), segment_budget)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_edge.numpy(), np.asarray(want_edge))
    assert want_valid.shape[1] == min(segment_budget, 320) and bool(want_valid.any())
    statics, _ = prc.init_rule_checker(
        _t(b["map/boundary"]), *(_t(x) for x in args), _t(b["agent/type"]), _t(b["agent/size"]),
        torch.ones(3, cfg.data.n_tl_lane, dtype=torch.bool), torch.zeros(3, cfg.data.n_tl_lane, 3),
        segment_budget=segment_budget)
    assert torch.equal(statics.road_edge, got_edge) and torch.equal(statics.road_edge_valid, got_valid)


def test_build_wosac_data_matches_jax():
    a, role = _filter_inputs(40, seed=6)
    batch = make_batch(tiny_config().data, n_sc=2, seed=3, test_mode=True)
    center, yaw = batch["scenario_center"], batch["scenario_yaw"]
    jbuf = types.SimpleNamespace(pred_pose=jnp.asarray(a["pred_pose"]),
                                 violation={k: jnp.asarray(v) for k, v in a["violation"].items()})
    pbuf = types.SimpleNamespace(pred_pose=_t(a["pred_pose"]), violation={k: _t(v) for k, v in a["violation"].items()})
    want = jws.build_wosac_data(JaxWOSACPostCfg(), jbuf, jnp.asarray(role), batch, 5, jnp.asarray(center),
                                jnp.asarray(yaw))
    got = pws.build_wosac_data(WOSACPostCfg(), pbuf, _t(role), {k: _t(v) for k, v in batch.items()}, 5, _t(center),
                               _t(yaw))
    assert set(got) == set(want) == {"trajs", *pws.WOSAC_HIST_KEYS}
    _close(got["trajs"][..., :2], want["trajs"][..., :2], atol=1e-3, msg="position (~1e2 m in float32)")
    _close(got["trajs"][..., 2], want["trajs"][..., 2], msg="yaw")
    for key in pws.WOSAC_HIST_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
