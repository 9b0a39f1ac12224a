"""Native WOSAC realism likelihoods (counterpart of `trafficbotsv15_tpu/eval/wosac_likelihood.py`).

The WOSAC realism metric scores, per scenario and agent, the log-likelihood
of the logged (ground-truth) feature values under the empirical
distribution of the K=32 simulated futures, then aggregates a weighted
"realism metametric" over three buckets (kinematic / interactive / map):
  - features from the trajectories: linear and angular speed and
    acceleration, the signed box distance to the nearest object (WOSAC's
    exact geometry, `sim/wosac_collision.py`), collision indication,
    time to collision, distance to the nearest road edge, offroad
    indication;
  - histogram likelihoods with additive smoothing (independent timesteps)
    and Bernoulli likelihoods for the indications;
  - the bucket aggregation with the challenge's published weights.
The port keeps its own copy of the JAX package's challenge tables.

Time to collision is the JAX package's estimator, not the official one: a
same-lane leader heuristic (an agent ahead within half the summed widths
laterally, constant-velocity closing time), where the official package
projects boxes along the heading. The TTC bucket tracks but does not
reproduce the official number.

Working set: the per-step features of a scenario cover K x n_step poses
(2,560 at the flagship), and the road-edge distance a [n_ag, n_seg] plane
per pose (64 x 6,144). Each such feature is computed over chunks of poses,
sized so that a temporary holds at most CHUNK_ELEMS elements; the chunks
do not change the result (every op is elementwise or a min over the last
axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.ops.transform import cast_rad
from trafficbotsv15_tpu_torch.sim.rule_checker import _check_run_road_edge, build_road_edges
from trafficbotsv15_tpu_torch.sim.wosac_collision import (EXTREMELY_LARGE_DISTANCE, get_ag_bbox, norm2,
                                                          pairwise_signed_distance_soa)

# elements of the largest temporary of one chunk: 512 MiB in float32, 1 GiB in int64
CHUNK_ELEMS = 2 ** 27


@dataclasses.dataclass(frozen=True)
class HistogramCfg:
    val_min: float
    val_max: float
    num_bins: int
    additive_smoothing: float = 0.001


# The 2024 challenge configuration (`challenge_2024_config.textproto` of waymo_open_dataset), as the JAX
# package transcribes it; tests hold this copy equal to it.
CHALLENGE_2024_CONFIG: Dict[str, Dict] = {
    "linear_speed": dict(histogram=HistogramCfg(0.0, 32.0, 64), independent_timesteps=True, metametric_weight=0.05),
    "linear_acceleration": dict(histogram=HistogramCfg(-12.0, 12.0, 48), independent_timesteps=True,
                                metametric_weight=0.05),
    "angular_speed": dict(histogram=HistogramCfg(-3.2, 3.2, 64), independent_timesteps=True, metametric_weight=0.05),
    "angular_acceleration": dict(histogram=HistogramCfg(-6.4, 6.4, 64), independent_timesteps=True,
                                 metametric_weight=0.05),
    "distance_to_nearest_object": dict(histogram=HistogramCfg(-10.0, 40.0, 50), independent_timesteps=True,
                                       metametric_weight=0.1),
    "collision_indication": dict(bernoulli_smoothing=0.001, independent_timesteps=False, metametric_weight=0.25),
    "time_to_collision": dict(histogram=HistogramCfg(0.0, 5.0, 25), independent_timesteps=True,
                              metametric_weight=0.1),
    "distance_to_road_edge": dict(histogram=HistogramCfg(-5.0, 5.0, 50), independent_timesteps=True,
                                  metametric_weight=0.1),
    "offroad_indication": dict(bernoulli_smoothing=0.001, independent_timesteps=False, metametric_weight=0.25),
}

FEATURE_CONFIG: Dict[str, HistogramCfg] = {
    name: cfg["histogram"] for name, cfg in CHALLENGE_2024_CONFIG.items() if "histogram" in cfg
}

# metametric weight of each likelihood field (normalised per bucket below)
FIELD_WEIGHTS = {f"{name}_likelihood": cfg["metametric_weight"] for name, cfg in CHALLENGE_2024_CONFIG.items()}
BUCKETS = {
    "kinematic_metrics": ["linear_speed_likelihood", "linear_acceleration_likelihood", "angular_speed_likelihood",
                          "angular_acceleration_likelihood"],
    "interactive_metrics": ["distance_to_nearest_object_likelihood", "collision_indication_likelihood",
                            "time_to_collision_likelihood"],
    "map_based_metrics": ["distance_to_road_edge_likelihood", "offroad_indication_likelihood"],
}


def map_rows(fn, elems_per_row: int, *rows: torch.Tensor) -> torch.Tensor:
    """fn over chunks of the leading axis of rows (equal leading sizes), results concatenated; a chunk
    holds at most CHUNK_ELEMS // elems_per_row rows, elems_per_row the size of fn's largest temporary
    per row."""
    n = rows[0].shape[0]
    size = max(1, CHUNK_ELEMS // elems_per_row)
    if size >= n:
        return fn(*rows)
    return torch.cat([fn(*(r[i:i + size] for r in rows)) for i in range(0, n, size)])


# --------------------------------------------------------------- features
def kinematic_features(trajs: torch.Tensor, dt: float = 0.1):
    """trajs [..., n_step, 3] -> (lin_speed, lin_acc, ang_speed, ang_acc), each [..., n_step - k].

    dt is divided by as a tensor on the trajectories' device: CUDA turns a division by a host scalar
    into a multiplication by its reciprocal, which rounds otherwise than the CPU and the JAX package,
    and a value one ulp off can change its histogram bin."""
    dt = torch.full((), dt, dtype=trajs.dtype, device=trajs.device)
    d = torch.diff(trajs[..., :2], dim=-2)
    lin_speed = norm2(d[..., 0], d[..., 1]) / dt
    lin_acc = torch.diff(lin_speed, dim=-1) / dt
    ang_speed = cast_rad(torch.diff(trajs[..., 2], dim=-1)) / dt
    ang_acc = torch.diff(ang_speed, dim=-1) / dt
    return lin_speed, lin_acc, ang_speed, ang_acc


def pairwise_signed_distance(pose: torch.Tensor, ag_size: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Signed distance to the nearest other valid agent [n_b, n_ag] (WOSAC geometry)."""
    return pairwise_signed_distance_soa(pose, ag_size, valid).amin(2)


def time_to_collision(pose, spd, ag_size, valid, max_ttc: float = 5.0) -> torch.Tensor:
    """Constant-velocity time to collision with the leader [n_b, n_ag]: the leader an agent ahead within
    half the summed widths laterally."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    dp = pose[:, None, :, :2] - pose[:, :, None, :2]  # i -> j
    lon = dp[..., 0] * c[:, :, None] + dp[..., 1] * s[:, :, None]
    lat = -dp[..., 0] * s[:, :, None] + dp[..., 1] * c[:, :, None]
    half_w = (ag_size[:, :, None, 1] + ag_size[:, None, :, 1]) * 0.5
    length_gap = lon - (ag_size[:, :, None, 0] + ag_size[:, None, :, 0]) * 0.5
    ahead = (length_gap > 0) & (lat.abs() < half_w)
    closing = spd[:, :, None] - spd[:, None, :]  # > 0: closing in
    ttc = torch.where(ahead & (closing > 0.1), length_gap / closing.clamp_min(0.1), max_ttc)
    eye = torch.eye(valid.shape[1], dtype=torch.bool, device=valid.device)[None]
    ttc = torch.where(~(valid[:, :, None] & valid[:, None, :]) | eye, max_ttc, ttc)
    return ttc.amin(2).clamp(0.0, max_ttc)


def distance_to_road_edge(pose, road_edge, road_edge_valid) -> torch.Tensor:
    """Distance to the nearest valid road-edge segment [n_b, n_ag] (unsigned). pose [n_b, n_ag, 3],
    road_edge [n_b or 1, n_seg, 2, 2], road_edge_valid [n_b or 1, n_seg]."""
    ax, ay = road_edge[..., 0, 0], road_edge[..., 0, 1]  # [n_b, n_seg]
    abx, aby = road_edge[..., 1, 0] - ax, road_edge[..., 1, 1] - ay
    denom = (abx * abx + aby * aby + 1e-9)[:, None]  # [n_b, 1, n_seg]
    ax, ay, abx, aby = ax[:, None], ay[:, None], abx[:, None], aby[:, None]
    px, py = pose[..., 0][..., None], pose[..., 1][..., None]  # [n_b, n_ag, 1]
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
    d = norm2(px - (ax + t * abx), py - (ay + t * aby))
    return torch.where(road_edge_valid[:, None, :], d, EXTREMELY_LARGE_DISTANCE).amin(2)


# ------------------------------------------------------------- likelihoods
def _bins(x: torch.Tensor, cfg: HistogramCfg) -> torch.Tensor:
    """Bin index: truncation towards zero of the scaled value, then the clip (the JAX package's
    float->int32 conversion, which saturates; clamping first keeps the conversion defined)."""
    scaled = (x - cfg.val_min) * (cfg.num_bins / (cfg.val_max - cfg.val_min))
    return scaled.clamp(-1.0, float(cfg.num_bins)).to(torch.int64).clamp(0, cfg.num_bins - 1)


def histogram_log_likelihood(sim: torch.Tensor, logged: torch.Tensor, sim_valid, logged_valid,
                             cfg: HistogramCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-agent (sum, count) of the logged values' log-likelihoods under the histogram of the simulated
    values pooled over futures and steps. sim [K, n_ag, n_step], logged [n_ag, n_step], masks alike.
    Sums and counts, so that callers take the official estimator's flat mean over valid samples."""
    n_ag = sim.shape[1]
    sim_bin = _bins(sim, cfg).transpose(0, 1).reshape(n_ag, -1)
    w = sim_valid.transpose(0, 1).reshape(n_ag, -1).float()
    counts = torch.zeros((n_ag, cfg.num_bins), device=sim.device).scatter_add_(1, sim_bin, w)  # exact integers
    probs = (counts + cfg.additive_smoothing) / (
        counts.sum(-1, keepdim=True) + cfg.additive_smoothing * cfg.num_bins)
    ll = torch.gather(torch.log(probs), 1, _bins(logged, cfg))  # [n_ag, n_step]
    return torch.where(logged_valid, ll, 0.0).sum(-1), logged_valid.sum(-1)


def bernoulli_log_likelihood(sim_flag: torch.Tensor, logged_flag: torch.Tensor, smoothing: float = 0.001):
    """sim_flag [K, n_ag] bool, logged_flag [n_ag] bool -> per-agent log-likelihood: a 2-bin histogram with
    additive smoothing, p = (count + eps) / (K + 2 eps)."""
    p = (sim_flag.sum(0) + smoothing) / (sim_flag.shape[0] + 2 * smoothing)
    return torch.where(logged_flag, torch.log(p), torch.log1p(-p))


def aggregate_metametric(likelihoods: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weighted buckets and the realism metametric; the weights renormalise over the fields present."""
    out = dict(likelihoods)
    total_w = sum(FIELD_WEIGHTS[k] for k in FIELD_WEIGHTS if k in likelihoods)
    meta = sum(FIELD_WEIGHTS[k] * likelihoods[k] for k in FIELD_WEIGHTS if k in likelihoods)
    out["metametric"] = meta / total_w
    for bucket, fields in BUCKETS.items():
        present = [f for f in fields if f in likelihoods]
        if present:
            w = sum(FIELD_WEIGHTS[f] for f in present)
            out[bucket] = sum(FIELD_WEIGHTS[f] * likelihoods[f] for f in present) / w
    return out


def _avg_exp(per_agent_ll: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """exp(mean log-likelihood) over valid agents, one sample each (the Bernoulli indications)."""
    n = valid.sum().clamp_min(1)
    return torch.exp(torch.where(valid, per_agent_ll, 0.0).sum() / n)


def _avg_exp_flat(ll_sum: torch.Tensor, ll_cnt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """exp of the flat mean log-likelihood over all valid agent-step samples."""
    s = torch.where(valid, ll_sum, 0.0).sum()
    n = torch.where(valid, ll_cnt, 0).sum().clamp_min(1)
    return torch.exp(s / n)


def _per_step(fn, elems_per_row: int, trajs: torch.Tensor, *per_step_args):
    """fn over every (future, step) pose set of trajs [K, n_ag, n_step, 3], chunked -> [K, n_ag, n_step].
    per_step_args: [K, n_ag, n_step, ...] tensors handed to fn per pose set."""
    k, n_ag, n_step = trajs.shape[:3]
    rows = [x.transpose(1, 2).reshape(k * n_step, n_ag, *x.shape[3:]) for x in (trajs, *per_step_args)]
    return map_rows(fn, elems_per_row, *rows).reshape(k, n_step, n_ag).transpose(1, 2)


def compute_scenario_likelihoods(sim_trajs: torch.Tensor, sim_valid: torch.Tensor, logged_trajs: torch.Tensor,
                                 logged_valid: torch.Tensor, ag_size: torch.Tensor,
                                 road_edge: Optional[torch.Tensor] = None,
                                 road_edge_valid: Optional[torch.Tensor] = None,
                                 sim_offroad: Optional[torch.Tensor] = None,
                                 logged_offroad: Optional[torch.Tensor] = None,
                                 dt: float = 0.1) -> Dict[str, torch.Tensor]:
    """Scenario-level likelihood fields and buckets. sim_trajs [K, n_ag, n_step, 3], sim_valid [n_ag]
    (constant over the future), logged_trajs [n_ag, n_step, 3], logged_valid [n_ag, n_step], ag_size
    [n_ag, 3], road_edge [n_seg, 2, 2], sim_offroad [K, n_ag], logged_offroad [n_ag]."""
    k, n_ag, n_step, _ = sim_trajs.shape
    v_step = logged_valid
    v_step_sim = sim_valid[None, :, None].expand(k, n_ag, n_step)
    logged = logged_trajs[None]  # one "future": the per-step features take [K, n_ag, n_step, ...]
    v_step_log = v_step[None]

    ls_s, la_s, as_s, aa_s = kinematic_features(sim_trajs, dt)
    ls_l, la_l, as_l, aa_l = kinematic_features(logged_trajs, dt)
    # a difference feature is valid where every step it uses is valid
    v1 = v_step[..., :-1] & v_step[..., 1:]
    v2 = v1[..., :-1] & v1[..., 1:]
    v1_sim = v_step_sim[..., :-1] & v_step_sim[..., 1:]
    v2_sim = v1_sim[..., :-1] & v1_sim[..., 1:]

    fields = {}
    for name, sim_f, log_f, sv, lv in (("linear_speed", ls_s, ls_l, v1_sim, v1),
                                       ("linear_acceleration", la_s, la_l, v2_sim, v2),
                                       ("angular_speed", as_s, as_l, v1_sim, v1),
                                       ("angular_acceleration", aa_s, aa_l, v2_sim, v2)):
        ll_sum, ll_cnt = histogram_log_likelihood(sim_f, log_f, sv, lv, FEATURE_CONFIG[name])
        fields[f"{name}_likelihood"] = _avg_exp_flat(ll_sum, ll_cnt, sim_valid)

    # distance to the nearest object, per step; the pair geometry holds 8 n_ag^2 values per pose set
    size2 = ag_size[..., :2]

    def nearest(pose, valid):
        return pairwise_signed_distance(pose, size2.expand(pose.shape[0], -1, -1), valid)

    sim_dist = _per_step(nearest, 8 * n_ag * n_ag, sim_trajs, v_step_sim)
    log_dist = _per_step(nearest, 8 * n_ag * n_ag, logged, v_step_log)[0]
    cfgd = FEATURE_CONFIG["distance_to_nearest_object"]
    ll_sum, ll_cnt = histogram_log_likelihood(sim_dist.clamp(cfgd.val_min, cfgd.val_max),
                                              log_dist.clamp(cfgd.val_min, cfgd.val_max), v_step_sim, v_step, cfgd)
    fields["distance_to_nearest_object_likelihood"] = _avg_exp_flat(ll_sum, ll_cnt, sim_valid)

    # collision indication: any step at a negative distance
    sim_col = ((sim_dist < 0) & v_step_sim).any(-1)
    log_col = ((log_dist < 0) & v_step).any(-1)
    fields["collision_indication_likelihood"] = _avg_exp(bernoulli_log_likelihood(
        sim_col, log_col, CHALLENGE_2024_CONFIG["collision_indication"]["bernoulli_smoothing"]), sim_valid)

    # time to collision; the speed at step t is that over (t - 1, t), zero where either step is invalid
    sim_spd = torch.cat([torch.where(v1_sim[..., :1], ls_s[..., :1], 0.0), torch.where(v1_sim, ls_s, 0.0)], -1)
    log_spd = torch.cat([torch.where(v1[..., :1], ls_l[..., :1], 0.0), torch.where(v1, ls_l, 0.0)], -1)

    def ttc(pose, spd, valid):
        return time_to_collision(pose, spd, ag_size.expand(pose.shape[0], -1, -1), valid)

    sim_ttc = _per_step(ttc, n_ag * n_ag, sim_trajs, sim_spd, v_step_sim)
    log_ttc = _per_step(ttc, n_ag * n_ag, logged, log_spd[None], v_step_log)[0]
    ll_sum, ll_cnt = histogram_log_likelihood(sim_ttc, log_ttc, v_step_sim, v_step, FEATURE_CONFIG["time_to_collision"])
    fields["time_to_collision_likelihood"] = _avg_exp_flat(ll_sum, ll_cnt, sim_valid)

    if road_edge is not None:
        def edge_dist(pose):
            return distance_to_road_edge(pose, road_edge[None], road_edge_valid[None])

        n_seg = road_edge.shape[0]
        cfge = FEATURE_CONFIG["distance_to_road_edge"]
        sim_red = _per_step(edge_dist, n_ag * n_seg, sim_trajs).clamp(cfge.val_min, cfge.val_max)
        log_red = _per_step(edge_dist, n_ag * n_seg, logged)[0].clamp(cfge.val_min, cfge.val_max)
        ll_sum, ll_cnt = histogram_log_likelihood(sim_red, log_red, v_step_sim, v_step, cfge)
        fields["distance_to_road_edge_likelihood"] = _avg_exp_flat(ll_sum, ll_cnt, sim_valid)
    if sim_offroad is not None and logged_offroad is not None:
        fields["offroad_indication_likelihood"] = _avg_exp(bernoulli_log_likelihood(
            sim_offroad, logged_offroad, CHALLENGE_2024_CONFIG["offroad_indication"]["bernoulli_smoothing"]),
            sim_valid)
    return aggregate_metametric(fields)


def realism_from_rollout(batch: Dict[str, torch.Tensor], pp, jf_buf, step_current: int,
                         segment_budget: int = 6144) -> Dict[str, torch.Tensor]:
    """The native realism metametric of a validation batch, per scenario: the future horizon of the K
    joint futures (flattened buffer [n_sc, K, ...]) against the logged ground truth; road edges from the
    packed map; simulated offroad from the rule checker's flags, logged offroad by replaying the same
    crossing test on the logged boxes. -> dict of [n_sc] tensors: the 9 likelihood fields, the buckets,
    "metametric", and WOSAC's average and min-average displacement errors. Futures past the log's horizon
    (the scaled preset) are scored over the logged steps only, the steps WOSAC scores; JAX's function raises
    there (the futures and the log do not broadcast)."""
    road_edge, road_edge_valid = build_road_edges(batch["map/valid"], batch["map/type"].bool(), batch["map/pos"],
                                                  batch["map/dir"], segment_budget)
    logged = pp.gt_pose[:, :, step_current + 1:].float()  # absolute steps aligned with sim
    logged_valid = pp.gt_valid[:, :, step_current + 1:]
    future = slice(step_current, step_current + logged.shape[2])
    sim = jf_buf.pred_pose[:, :, :, future].float()  # [n_sc, K, n_ag, n_fut, 3]
    # every agent present anywhere in the futures is simulated over the whole horizon
    sim_valid = jf_buf.pred_valid[:, :, :, future].any(3).any(1)  # [n_sc, n_ag]
    ag_size = pp.ag_size.float()
    sim_offroad = jf_buf.violation["run_road_edge_this_step"][:, :, :, future].any(-1)  # [n_sc, K, n_ag]

    # logged offroad: the crossing test of every (step, scenario), [n_ag, n_seg] per box edge
    n_sc, n_ag, n_fut = logged_valid.shape
    n_seg = road_edge.shape[1]

    def offroad(pose, valid, size, veh, edge, edge_valid):
        return _check_run_road_edge(valid, get_ag_bbox(pose, size), veh, edge, edge_valid)

    def steps(x):  # [n_sc, ...] -> [n_fut * n_sc, ...], step-major
        return x[None].expand(n_fut, *x.shape).reshape(n_fut * n_sc, *x.shape[1:])

    logged_offroad = map_rows(offroad, n_ag * n_seg, logged.movedim(2, 0).reshape(n_fut * n_sc, n_ag, 3),
                              logged_valid.movedim(2, 0).reshape(n_fut * n_sc, n_ag), steps(ag_size[..., :2]),
                              steps(pp.ag_type[:, :, 0]), steps(road_edge), steps(road_edge_valid))
    logged_offroad = logged_offroad.reshape(n_fut, n_sc, n_ag).any(0)

    out = []
    for i in range(n_sc):
        s, sv, lg, lv = sim[i], sim_valid[i], logged[i], logged_valid[i]
        fields = compute_scenario_likelihoods(s, sv, lg, lv, ag_size[i], road_edge=road_edge[i],
                                              road_edge_valid=road_edge_valid[i], sim_offroad=sim_offroad[i],
                                              logged_offroad=logged_offroad[i])
        # WOSAC's displacement errors: per-agent ADE over valid steps; ADE the mean over the futures of
        # the agent-averaged ADE, minADE the min over the futures of it (not a per-agent min)
        mask = sv[None, :, None] & lv[None]
        d = s[..., :2] - lg[None, ..., :2]
        dist = torch.where(mask, norm2(d[..., 0], d[..., 1]), 0.0)
        ade_k = dist.sum(-1) / mask.sum(-1).clamp_min(1)  # [K, n_ag]
        ag_mask = sv & lv.any(-1)
        ade_scen = torch.where(ag_mask[None], ade_k, 0.0).sum(1) / ag_mask.sum().clamp_min(1)  # [K]
        fields["average_displacement_error"] = ade_scen.mean()
        fields["min_average_displacement_error"] = ade_scen.amin()
        out.append(fields)
    return {k: torch.stack([f[k] for f in out]) for k in out[0]}
