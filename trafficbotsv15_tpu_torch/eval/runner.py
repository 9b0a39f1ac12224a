"""Validation and submission runners (counterpart of `trafficbotsv15_tpu/eval/runner.py`).

`make_validate_step` is one validation batch: reactive replay with its loss
and error and rule sums, the K joint futures with their rule sums, WOMD
post-processing (K -> 6 modes) and native motion metrics on both rollouts,
the WOSAC future filter and the native WOSAC realism metametric. `validate`
runs it over a loader and reduces the metrics under the JAX package's
names; `test_submission` makes the WOMD and WOSAC submissions of the test
split. Neither restores a checkpoint. With `video_dir`, `validate` first
renders `n_vis_batch` scenarios of a reactive replay of its first batch
(`save_validation_videos`: the host-side inputs of `validation_video_inputs`,
the frames of `utils/visualization.py`, which needs `cv2`).

The official Waymo metrics are host-side and gated on their packages, as in
the JAX package: where Waymo's WOMD op and TensorFlow are importable
(`_womd_official_available`), `validate` packs each batch's WOMD inputs of
the joint futures and of reactive replay and makes one official call per
flavour at the end over the concatenated rows; where `waymo_open_dataset`
imports and a batch carries `scenario_bytes` and `scenario_id`, it feeds the
WOSAC pool (`eval/wosac_metrics.py`) from the filtered futures, in the global
frame where the batch has `scenario_center`.

Over several ranks (`parallel/mesh.py`) each rank evaluates its shard on its
device, and the results are combined as the JAX package combines its hosts':
one sum over the ranks of the running sums and of the per-batch loss and WOMD
sums and counts, the WOSAC pool's sums and counter summed before its
aggregation, and the WOMD rows and the submission's rows gathered to rank 0,
which alone makes the official WOMD call (its metrics then go to every rank)
and writes the submission.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.eval.metrics import (compute_error_metrics, compute_traffic_rule_metrics,
                                                   error_metric_sums, merge_sums, traffic_rule_sums)
from trafficbotsv15_tpu_torch.eval import womd_metrics
from trafficbotsv15_tpu_torch.eval.womd_metrics import native_motion_metrics, pack_waymo_inputs
from trafficbotsv15_tpu_torch.eval.womd_post_processing import womd_post_process
from trafficbotsv15_tpu_torch.eval.wosac_likelihood import realism_from_rollout
from trafficbotsv15_tpu_torch.eval.wosac_post_processing import (WOSAC_HIST_KEYS, filter_futures,
                                                                 get_scenario_rollouts, to_global_frame)
from trafficbotsv15_tpu_torch.parallel.mesh import (allgather_rows, broadcast_object, cross_process_max,
                                                    cross_process_sum, process_index)
from trafficbotsv15_tpu_torch.train import evaluation
from trafficbotsv15_tpu_torch.train.losses import training_loss
from trafficbotsv15_tpu_torch.utils.device import resolve_device, to_host
from trafficbotsv15_tpu_torch.utils.logging import MetricsLogger

SPLIT_PARTS = ("reactive_replay", "joint_futures", "post_and_metrics", "realism")


def make_validate_step(cfg: ExperimentCfg, model, device=None):
    """step(batch, generator, split=None) -> out, the JAX step's `out` keys with tensor values on the device.

    batch: h5-schema dict with the ground truth; generator draws the joint futures' latents and
    navi, and with `pred_navi_after_reached` the navi re-predicted in both rollouts (reactive replay's
    first). With a dict as `split`, the step synchronises the device after each part and adds
    its seconds under SPLIT_PARTS (a measurement aid; the result is the same)."""
    device = resolve_device(device)
    evaluation.check_model(model, device)

    def mark(split, part=None, t0=0.0):
        """With a split dict: synchronise the device and add the seconds since t0 under part. -> now."""
        if split is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if split is not None and part is not None:
            split[part] = split.get(part, 0.0) + now - t0
        return now

    @torch.no_grad()
    def step(batch, generator: torch.Generator, split: Optional[Dict[str, float]] = None):
        t0 = mark(split)
        batch = evaluation.batch_to_device(batch, device)
        pp, rr_buf, navi_pred, post, prior = evaluation.reactive_replay(cfg, model, batch, device=device,
                                                                        generator=generator)
        rr_flat = rr_buf.flatten_joint_future(1)
        _, loss_metrics = training_loss(cfg.training_metrics, rr_buf, pp.ag_role, navi_pred, pp.gt_navi, post, prior,
                                        prefix="reactive_replay")
        err_sums = error_metric_sums(rr_flat, pp.gt_valid, pp.gt_pose, pp.gt_motion)
        rr_rule = traffic_rule_sums(rr_flat, pp.ag_type)
        t0 = mark(split, "reactive_replay", t0)

        pp2, jf_buf = evaluation.joint_future_pred(cfg, model, batch, generator=generator, device=device)
        t0 = mark(split, "joint_futures", t0)
        jf_rule = traffic_rule_sums(jf_buf, pp2.ag_type)
        n_future = cfg.time_step_gt - cfg.time_step_current
        womd = womd_post_process(cfg.womd_post, pp2.ag_type, jf_buf.pred_pose[:, :, :, cfg.time_step_current:],
                                 jf_buf.log_prob, track_future_samples=n_future)
        wosac_trajs = filter_futures(cfg.wosac_post, jf_buf, pp2.ag_role, cfg.time_step_current)
        out = dict(loss_metrics=loss_metrics, err_sums=err_sums, rr_rule=rr_rule, jf_rule=jf_rule,
                   womd_trajs=womd["trajs"], womd_scores=womd["scores"], wosac_trajs=wosac_trajs)
        if pp2.gt_valid is not None and womd["trajs"].shape[3] > 0:
            # native WOMD motion metrics on the reduced modes, of the joint futures and of reactive replay
            out["womd_metric_vals"] = native_motion_metrics(
                womd["trajs"], womd["scores"], gt_pos=pp2.gt_pose[..., :2], gt_yaw=pp2.gt_pose[..., 2],
                gt_valid=pp2.gt_valid, gt_spd=pp2.gt_motion[..., 0], mask_pred=pp2.ag_role[..., 2],
                step_current=cfg.time_step_current)
            womd_rr = womd_post_process(cfg.womd_post, pp.ag_type,
                                        rr_buf.pred_pose[:, None, :, cfg.time_step_current:], None,
                                        track_future_samples=n_future)
            if womd_rr["trajs"].shape[3] > 0:
                out["womd_rr_metric_vals"] = native_motion_metrics(
                    womd_rr["trajs"], womd_rr["scores"], gt_pos=pp.gt_pose[..., :2], gt_yaw=pp.gt_pose[..., 2],
                    gt_valid=pp.gt_valid, gt_spd=pp.gt_motion[..., 0], mask_pred=pp.ag_role[..., 2],
                    step_current=cfg.time_step_current)
                out["womd_rr_trajs"] = womd_rr["trajs"]
                out["womd_rr_scores"] = womd_rr["scores"]
        t0 = mark(split, "post_and_metrics", t0)
        if cfg.native_wosac_realism and pp2.gt_valid is not None:
            out["wosac_realism"] = realism_from_rollout(batch, pp2, jf_buf, cfg.time_step_current)
            mark(split, "realism", t0)
        return out

    return step


def validation_video_inputs(cfg: ExperimentCfg, batch, buf, i: int) -> Tuple[dict, dict]:
    """Scenario i's (episode, prediction) dicts of `utils/visualization.py::save_prediction_videos`, as numpy arrays
    on the host (JAX `runner.py::save_validation_videos`).

    batch: the h5-schema batch; buf: a reactive-replay RolloutBuffer flattened to one future
    (`flatten_joint_future(1)`, [n_sc, 1, ...]). episode: the batch's map/, agent/, tl_lane/ and tl_stop/ arrays of
    scenario i. prediction: from step time_step_current on, the predicted agent/valid, agent/pos, agent/yaw_bbox,
    action, act_P, the predicted TL states under the key of cfg.model.tl_mode's tokens (tl_lane/state or
    tl_stop/state), each violation and, where the replay filled it, diffbar_reward; score where the buffer has
    joint-future scores; step_current, step_gt and step_end."""
    episode = {k: to_host(v[i]) for k, v in batch.items()
               if not isinstance(v, list) and k.startswith(("map/", "agent/", "tl_lane/", "tl_stop/"))}
    cur = cfg.time_step_current
    ahead = lambda x: to_host(x[i, 0, :, cur:])  # noqa: E731
    pose = ahead(buf.pred_pose)
    prediction = {"step_current": cur, "step_gt": cfg.time_step_gt, "step_end": cfg.time_step_end,
                  "agent/valid": ahead(buf.pred_valid), "agent/pos": pose[..., :2], "agent/yaw_bbox": pose[..., 2:3],
                  "action": ahead(buf.pred_action), "act_P": ahead(buf.action_log_prob)}
    tl_key = "tl_lane/state" if cfg.model.tl_mode == "lane" else "tl_stop/state"  # rows follow the TL tokens
    prediction[tl_key] = ahead(buf.tl_state)
    if buf.log_prob is not None:
        prediction["score"] = to_host(buf.log_prob[i, 0])
    for k, v in buf.violation.items():
        prediction[k] = ahead(v)
    if buf.diffbar_reward is not None and "diffbar_reward" in buf.diffbar_reward:
        prediction["diffbar_reward"] = ahead(buf.diffbar_reward["diffbar_reward"])
    return episode, prediction


def save_validation_videos(cfg: ExperimentCfg, batch, buf, out_dir: str = "videos", n_vis: int = 1) -> List[str]:
    """Render reactive-replay rollout videos (waymo_motion.py:717-818) of the first n_vis scenarios: per scenario
    the gt/pd/mix videos and the agent-centric views with the violation/action text sidebar
    (`save_prediction_videos` of `validation_video_inputs`), and one overview video of the whole rollout with the
    collided agents outlined; -> the written paths. buf as `validation_video_inputs`'s."""
    from trafficbotsv15_tpu_torch.utils.visualization import save_prediction_videos, save_rollout_video

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    paths: List[str] = []
    for i in range(min(n_vis, buf.pred_valid.shape[0])):
        episode, prediction = validation_video_inputs(cfg, batch, buf, i)
        paths += save_prediction_videos(f"{out_dir}/scenario_{i}", episode, prediction)
        collided = buf.violation.get("collided")
        paths.append(save_rollout_video(
            f"{out_dir}/scenario_{i}.mp4", episode["map/valid"], episode["map/type"], episode["map/pos"],
            episode["map/boundary"], pred_pose=to_host(buf.pred_pose[i, 0]), pred_valid=to_host(buf.pred_valid[i, 0]),
            ag_size=episode["agent/size"], ag_role=episode["agent/role"],
            violation=None if collided is None else to_host(collided[i, 0])))
    return paths


def render_validation_videos(cfg: ExperimentCfg, model, val_loader, video_dir: str, device=None) -> List[str]:
    """`save_validation_videos` of cfg.n_vis_batch scenarios of a reactive replay of val_loader's first batch, its
    draws from a generator seeded with 0 (JAX `runner.py:396-403`)."""
    first = next(iter(val_loader))
    batch = {k: v for k, v in first.items() if not isinstance(v, list)}
    with torch.no_grad():
        _, buf, _, _, _ = evaluation.reactive_replay(cfg, model, batch, device=device,
                                                     generator=torch.Generator().manual_seed(0))
    return save_validation_videos(cfg, batch, buf.flatten_joint_future(1), out_dir=video_dir, n_vis=cfg.n_vis_batch)


def validate(cfg: ExperimentCfg, model, val_loader, max_batches: Optional[int] = None,
             logger: Optional[MetricsLogger] = None, device=None, video_dir: Optional[str] = None) -> Dict[str, float]:
    """Validation over val_loader's batches on one device: the per-batch sums and means reduced under the
    JAX package's metric names (`val/loss`, `wosac/*`, `wosac_likelihood/*`, `joint_future_pred/womd/*`,
    `reactive_replay/*`, `joint_future_pred/traffic_rule/*`, `val/scenarios_per_sec`), and the official
    metrics where their packages are importable (`joint_future_pred/waymo_metrics/*`,
    `reactive_replay/waymo_metrics/*`, `wosac/wosac/*`, `wosac/wosac_likelihood/*`). Batch i draws its joint
    futures from a generator seeded with cfg.seed + i, as the JAX package keys it. Over several ranks every rank
    evaluates its own loader's batches and returns the same metrics, the union's (`metrics_from_sums`). With
    video_dir, rank 0 first renders the validation videos there (`render_validation_videos`)."""
    step = make_validate_step(cfg, model, device)
    if video_dir and process_index() == 0:
        render_validation_videos(cfg, model, val_loader, video_dir, device=device)
    logger = logger or MetricsLogger()
    try:
        from trafficbotsv15_tpu_torch.eval.wosac_metrics import WOSACMetrics

        wosac_official = WOSACMetrics("wosac")
    except ImportError:
        wosac_official = None
    womd_official_ok = _womd_official_available()
    womd_packed, womd_rr_packed = [], []
    err_sums, rr_rule, jf_rule, losses, womd_vals = {}, {}, {}, [], []
    realism_sums: Dict[str, float] = {}
    realism_n = n = 0
    t0 = time.time()
    for i, batch in enumerate(val_loader):
        if max_batches and i >= max_batches:
            break
        b = {k: v for k, v in batch.items() if not isinstance(v, list)}  # scenario bytes are ragged
        out = step(b, torch.Generator().manual_seed(cfg.seed + i))
        err_sums = merge_sums(err_sums, out["err_sums"])
        rr_rule = merge_sums(rr_rule, out["rr_rule"])
        jf_rule = merge_sums(jf_rule, out["jf_rule"])
        losses.append({k: float(v) for k, v in out["loss_metrics"].items()})
        if "womd_metric_vals" in out:
            womd_vals.append({k: float(v) for k, v in out["womd_metric_vals"].items()})
        if "womd_rr_metric_vals" in out:
            losses[-1].update({f"reactive_replay/womd/{k}": float(v) for k, v in out["womd_rr_metric_vals"].items()})
        if "wosac_realism" in out:
            for k, v in out["wosac_realism"].items():
                realism_sums[k] = realism_sums.get(k, 0.0) + float(v.double().sum())
            realism_n += int(next(iter(out["wosac_realism"].values())).shape[0])
        if womd_official_ok and all(k in b for k in _WOMD_GT_KEYS):
            gt = {k: to_host(b[k]) for k in _WOMD_GT_KEYS}
            womd_packed.append(pack_waymo_inputs(gt, to_host(out["womd_trajs"]), to_host(out["womd_scores"]),
                                                 cfg.time_step_gt, cfg.time_step_current))
            if "womd_rr_trajs" in out:
                womd_rr_packed.append(pack_waymo_inputs(gt, to_host(out["womd_rr_trajs"]),
                                                        to_host(out["womd_rr_scores"]), cfg.time_step_gt,
                                                        cfg.time_step_current))
        if wosac_official is not None and "scenario_bytes" in batch and "scenario_id" in batch:
            trajs = out["wosac_trajs"]
            if "scenario_center" in b:
                trajs = to_global_frame(trajs, *(torch.as_tensor(b[k], device=trajs.device)
                                                 for k in ("scenario_center", "scenario_yaw")))
            wd = {"trajs": to_host(trajs), **{k: to_host(b[k]) for k in WOSAC_HIST_KEYS}}
            rollouts = get_scenario_rollouts(cfg.wosac_post, wd, cfg.time_step_current, cfg.time_step_gt,
                                             _decode_sids(to_host(b["scenario_id"])))
            wosac_official.update(rollouts, [x.tobytes().hex() if hasattr(x, "tobytes") else x
                                             for x in batch["scenario_bytes"]])
        n += int(b["map/valid"].shape[0])

    # the union's sums (JAX `runner.py:486-499`): the ranks' loaders run the same number of batches, so the summed
    # per-batch means divide by the summed batch count
    sums = cross_process_sum({
        "err": err_sums, "rr": rr_rule, "jf": jf_rule, "realism": realism_sums, "realism_n": realism_n, "n": n,
        "loss": {k: float(np.sum([loss[k] for loss in losses])) for k in (losses[0] if losses else {})},
        "loss_cnt": len(losses),
        "womd": {k: float(np.sum([w[k] for w in womd_vals])) for k in (womd_vals[0] if womd_vals else {})},
        "womd_cnt": len(womd_vals),
    })
    elapsed = cross_process_max(time.time() - t0)
    metrics: Dict[str, float] = {}
    if wosac_official is not None:  # every rank takes part, with zero scenarios too
        red = cross_process_sum({"sums": wosac_official.sums, "counter": wosac_official.counter})
        wosac_official.sums = {k: float(v) for k, v in red["sums"].items()}
        wosac_official.counter = int(red["counter"])
        if wosac_official.counter > 0:
            metrics.update(wosac_official.compute())
    official: Dict[str, float] = {}
    for prefix, plist in (("joint_future_pred", womd_packed), ("reactive_replay", womd_rr_packed)):
        if plist:  # one official call per flavour over every rank's rows, on rank 0
            packed = allgather_rows({k: np.concatenate([p[k] for p in plist]) for k in plist[0]})
            if process_index() == 0:
                official.update(womd_metrics.official_motion_metrics(packed, cfg.time_step_current, prefix))
    if womd_packed:
        metrics.update(broadcast_object(official))
    metrics.update(metrics_from_sums(sums))
    metrics["val/scenarios_per_sec"] = float(sums["n"]) / elapsed
    logger.log(0, metrics)
    return metrics


def metrics_from_sums(sums) -> Dict[str, float]:
    """The metrics of `validate`'s running sums (its `cross_process_sum` tree), as JAX `runner.py:504-547`
    reduces them, but `val/scenarios_per_sec` and the official metrics."""
    metrics: Dict[str, float] = {}
    realism_n = int(sums["realism_n"])
    if realism_n > 0:
        mean = {k: float(v) / realism_n for k, v in sums["realism"].items()}
        metrics["wosac/realism_meta_metric"] = mean.pop("metametric")
        for bucket in ("kinematic_metrics", "interactive_metrics", "map_based_metrics"):
            metrics[f"wosac/{bucket}"] = mean.pop(bucket)
        metrics["wosac/min_ade"] = mean["min_average_displacement_error"]
        for k, v in mean.items():
            metrics[f"wosac_likelihood/{k}"] = v
    for k, v in sums["womd"].items():
        metrics[f"joint_future_pred/womd/{k}"] = float(v) / max(int(sums["womd_cnt"]), 1)
    metrics.update(compute_error_metrics(sums["err"], "reactive_replay"))
    metrics.update(compute_traffic_rule_metrics(sums["rr"], "reactive_replay"))
    metrics.update(compute_traffic_rule_metrics(sums["jf"], "joint_future_pred"))
    for k, v in sums["loss"].items():
        metrics[k] = float(v) / max(int(sums["loss_cnt"]), 1)
    metrics["val/loss"] = metrics.get("reactive_replay/loss", 0.0)
    return metrics


# the batch keys the official WOMD op's ground truth is packed from
_WOMD_GT_KEYS = ("agent/role", "agent/valid", "agent/pos", "agent/size", "agent/yaw_bbox", "agent/vel", "agent/type")


def _womd_official_available() -> bool:
    """Waymo's C++/TensorFlow motion-metrics op importable? (Tests monkeypatch this to run the packing and the
    epoch-end call.)"""
    import importlib.util

    try:
        return (importlib.util.find_spec("waymo_open_dataset.metrics.ops") is not None
                and importlib.util.find_spec("tensorflow") is not None)
    except ImportError:
        return False


def _decode_sids(id_rows) -> list:
    """Scenario-id char-code rows (zero-padded) back to strings."""
    return ["".join(chr(c) for c in row if c > 0) for row in id_rows]


def test_submission(cfg: ExperimentCfg, model, test_loader, out_dir: str = ".", n_joint_future: Optional[int] = None,
                    max_batches: Optional[int] = None, meta=None, device=None):
    """WOMD and WOSAC submissions of the test split (no ground truth): K joint futures per scenario (K from
    `cfg.n_joint_future_wosac` unless given; the submission config sets 128), WOMD post-processing to 6
    modes, the 32 futures with the fewest violations, in the global frame. Batch i draws from a generator
    seeded with cfg.seed + i. A tail batch smaller than the first is padded with its last scenario and
    sliced back. Writes the protos and returns the (WOMD, WOSAC) tar paths when waymo_open_dataset is
    importable, else returns the per-batch arrays. Over several ranks each rank runs its own loader's batches;
    with the protos every batch's rows are gathered to rank 0, which alone assembles and writes them, and the
    other ranks return (None, None); without them each rank returns its own arrays."""
    from trafficbotsv15_tpu_torch.eval.submission import SubmissionMeta, SubWOMD, SubWOSAC

    device = resolve_device(device)
    k = n_joint_future if n_joint_future is not None else cfg.n_joint_future_wosac
    meta = meta or SubmissionMeta()
    rank0 = process_index() == 0
    try:
        # an active writer imports waymo_open_dataset, or raises ImportError, on every rank alike (an inactive one
        # imports nothing); only rank 0's is ever fed and saved
        sub_womd = SubWOMD(meta)
        sub_wosac = SubWOSAC(meta, is_active=rank0, out_dir=f"{out_dir}/WOSAC")
        have_protos = True
    except ImportError:
        sub_womd = sub_wosac = None
        have_protos = False

    results = []
    n_full = None
    for i, batch in enumerate(test_loader):
        if max_batches and i >= max_batches:
            break
        b = {kk: np.asarray(v) for kk, v in batch.items() if not isinstance(v, list)}
        n_real = next(iter(b.values())).shape[0]
        n_full = n_real if n_full is None else n_full
        if n_real > n_full:
            raise ValueError(f"test batch grew from {n_full} to {n_real}")
        if n_real < n_full:  # pad with the last scenario: a submission must cover every scenario
            b = {kk: np.concatenate([v, np.repeat(v[-1:], n_full - n_real, axis=0)]) for kk, v in b.items()}
        pp, buf = evaluation.joint_future_pred(cfg, model, b, generator=torch.Generator().manual_seed(cfg.seed + i),
                                               n_joint_future=k, device=device)
        womd = womd_post_process(cfg.womd_post, pp.ag_type, buf.pred_pose[:, :, :, cfg.time_step_current:],
                                 buf.log_prob, track_future_samples=cfg.time_step_gt - cfg.time_step_current)
        wosac_trajs = filter_futures(cfg.wosac_post, buf, pp.ag_role, cfg.time_step_current)
        b = {kk: v[:n_real] for kk, v in b.items()}  # drop the padded duplicates
        womd = {kk: v[:n_real] for kk, v in womd.items()}
        wosac_trajs, role = wosac_trajs[:n_real], pp.ag_role[:n_real, :, 2].cpu().numpy()
        if "scenario_center" in b:
            wosac_trajs = to_global_frame(wosac_trajs, torch.from_numpy(b["scenario_center"]).to(device),
                                          torch.from_numpy(b["scenario_yaw"]).to(device))
        out = {kk: v.float().cpu().numpy() for kk, v in (("womd_trajs", womd["trajs"]), ("womd_scores", womd["scores"]),
                                                          ("wosac_trajs", wosac_trajs))}  # bf16 scores as float32
        results.append(out)
        if have_protos:
            g = out["womd_trajs"][..., :2]
            if "scenario_center" in b:
                cy = b["scenario_yaw"]
                rot = np.stack([np.stack([np.cos(cy), np.sin(cy)], -1), np.stack([-np.sin(cy), np.cos(cy)], -1)], -2)
                g = g @ rot[:, None, None] + b["scenario_center"][:, None, None, None]
            rows = allgather_rows({"sid": b["scenario_id"], "g": g, "scores": out["womd_scores"], "role": role,
                                   "trajs": out["wosac_trajs"], **{kk: b[kk] for kk in WOSAC_HIST_KEYS}})
            if rank0:
                sids = _decode_sids(rows["sid"])
                sub_womd.add(sids, rows["g"], rows["scores"], rows["history/agent/object_id"], rows["role"])
                wd = {"trajs": rows["trajs"], **{kk: rows[kk] for kk in WOSAC_HIST_KEYS}}
                sub_wosac.add(get_scenario_rollouts(cfg.wosac_post, wd, cfg.time_step_current, cfg.time_step_gt,
                                                    sids))
    if have_protos:
        return (sub_womd.save(out_dir), sub_wosac.save()) if rank0 else (None, None)
    return results
