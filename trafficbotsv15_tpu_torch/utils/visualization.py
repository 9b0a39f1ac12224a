"""Rollout visualization: rasterized map + agents + traffic lights -> mp4/jpg
(counterpart of `trafficbotsv15_tpu/utils/visualization.py`, kept as the port's own copy).

A feature-parity reimplementation of the reference's VisWaymo (vis_waymo.py,
835 LoC with video_recorder.py), numpy and OpenCV on the host:
  - per-lane-type map styling (color + thickness table, vis_waymo.py:66-78)
  - traffic-light rendering: lane polylines colored by state with end marker,
    stop points as arrowed lines (vis_waymo.py:240-290)
  - gt / pd / mix prediction videos with filled role-colored agent boxes and
    heading arrows (vis_waymo.py:177-360)
  - agent-centric warped views with the per-step text sidebar: violation
    this-step/cumulative counters, action (acc, steer), scores, diffbar
    rewards (vis_waymo.py:365-518)
  - destination-probability heatmap images with top-6 highlighting and gt
    dest overlay (vis_waymo.py:570-643)

Given the same inputs, every frame equals the JAX package's pixel for pixel.
Videos are written with cv2.VideoWriter (replacing the reference's ffmpeg
subprocess ImageEncoder); PNG frame dumps are the codec-free fallback.

`cv2` is imported on first use (`require_cv2`): where it does not import,
drawing raises an ImportError that names it, before any frame is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def require_cv2(what: str = "rendering"):
    """The cv2 module, or an ImportError that names it and what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which does not import here: {e}") from e
    return cv2

# tango palette subset, RGB (vis_waymo.py:7-48); frames are written RGB->BGR
# at encode time like the reference's cv2.imwrite(im[..., ::-1])
COLOR_WHITE = (255, 255, 255)
COLOR_BLACK = (0, 0, 0)
COLOR_RED = (255, 0, 0)
COLOR_GREEN = (0, 255, 0)
COLOR_CYAN = (0, 255, 255)
COLOR_MAGENTA = (255, 0, 255)
COLOR_YELLOW = (255, 255, 0)
COLOR_VIOLET = (170, 0, 255)
COLOR_BUTTER_0 = (252, 233, 79)
COLOR_ORANGE_2 = (209, 92, 0)
COLOR_CHOCOLATE_2 = (143, 89, 2)
COLOR_CHAMELEON_2 = (78, 154, 6)
COLOR_SKY_BLUE_0 = (114, 159, 207)
COLOR_SKY_BLUE_2 = (32, 74, 135)
COLOR_PLUM_2 = (92, 53, 102)
COLOR_SCARLET_RED_2 = (164, 0, 0)
COLOR_ALUMINIUM_0 = (238, 238, 236)
COLOR_ALUMINIUM_1 = (211, 215, 207)
COLOR_ALUMINIUM_4_5 = (66, 62, 64)

# (color, thickness) per waymo lane type (vis_waymo.py:66-78)
LANE_STYLE = [
    (COLOR_WHITE, 6),  # FREEWAY
    (COLOR_ALUMINIUM_4_5, 6),  # SURFACE_STREET
    (COLOR_ORANGE_2, 6),  # STOP_SIGN
    (COLOR_CHOCOLATE_2, 6),  # BIKE_LANE
    (COLOR_SKY_BLUE_2, 4),  # ROAD_EDGE_BOUNDARY
    (COLOR_PLUM_2, 4),  # ROAD_EDGE_MEDIAN
    (COLOR_BUTTER_0, 2),  # BROKEN
    (COLOR_MAGENTA, 2),  # SOLID_SINGLE
    (COLOR_SCARLET_RED_2, 2),  # DOUBLE
    (COLOR_CHAMELEON_2, 4),  # SPEED_BUMP
    (COLOR_SKY_BLUE_0, 4),  # CROSSWALK
]
# per tl state: unknown / stop / caution / go / flashing (vis_waymo.py:80-86)
TL_STYLE = [COLOR_ALUMINIUM_1, COLOR_RED, COLOR_YELLOW, COLOR_GREEN, COLOR_VIOLET]
# sdc / interest / predict (vis_waymo.py:88)
AGENT_ROLE_STYLE = [COLOR_CYAN, COLOR_CHAMELEON_2, COLOR_MAGENTA]

# violation counters shown in the sidebar: (label, buffer key stem)
_TXT_VIOLATIONS = [
    ("out", "outside_map"),
    ("col", "collided"),
    ("col_way", "collided_wosac"),
    ("red", "run_red_light"),
    ("edge", "run_road_edge"),
    ("passive", "passive"),
    ("r_goal", "goal_reached"),
    ("r_dest", "dest_reached"),
]


def _role_color(role_row: Optional[np.ndarray]):
    if role_row is None or not role_row.any():
        return COLOR_ALUMINIUM_0
    return AGENT_ROLE_STYLE[int(np.where(role_row)[0].min())]


def _agent_corners(pose: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Vectorized bbox corners [n, 4, 2] from pose [n, 3] and size [n, >=2]."""
    c, s = np.cos(pose[:, 2]), np.sin(pose[:, 2])
    fwd = np.stack([c, s], -1) * (0.5 * size[:, :1])
    right = np.stack([s, -c], -1) * (0.5 * size[:, 1:2])
    center = pose[:, :2]
    return np.stack([center - fwd + right, center + fwd + right,
                     center + fwd - right, center - fwd - right], axis=1)


class SceneRenderer:
    """Raster map + per-step drawing in the scene-centric frame."""

    def __init__(self, map_valid, map_type, map_pos, map_boundary,
                 px_per_m: float = 4.0, max_size: int = 1280):
        require_cv2("SceneRenderer")
        self.px_per_m = px_per_m
        self.map_valid = np.asarray(map_valid, bool)
        self.map_type = np.asarray(map_type, bool)
        self.map_pos = np.asarray(map_pos)
        xmin, xmax, ymin, ymax = [float(v) for v in map_boundary]
        pad = 20.0
        self.xmin, self.ymin = xmin - pad, ymin - pad
        w = int(min((xmax - xmin + 2 * pad) * px_per_m, max_size))
        h = int(min((ymax - ymin + 2 * pad) * px_per_m, max_size))
        self.size = (max(w, 64), max(h, 64))
        self.sx = self.size[0] / (xmax - xmin + 2 * pad)
        self.sy = self.size[1] / (ymax - ymin + 2 * pad)
        self.base = self.draw_map()

    def _to_px(self, xy: np.ndarray) -> np.ndarray:
        px = (xy[..., 0] - self.xmin) * self.sx
        py = self.size[1] - (xy[..., 1] - self.ymin) * self.sy
        return np.stack([px, py], axis=-1).astype(np.int32)

    # ------------------------------------------------------------------ map
    def draw_map(self, img: Optional[np.ndarray] = None,
                 map_valid=None, map_type=None, map_pos=None,
                 attn_weights: Optional[np.ndarray] = None) -> np.ndarray:
        """Lane-type-styled polylines; attn_weights > 0 scale the color
        (vis_waymo.py:128-176, incl. the attention-heatmap mode)."""
        cv2 = require_cv2()
        if img is None:
            img = np.zeros((self.size[1], self.size[0], 3), np.uint8)
        valid = self.map_valid if map_valid is None else np.asarray(map_valid, bool)
        mtype = self.map_type if map_type is None else np.asarray(map_type, bool)
        pos = self.map_pos if map_pos is None else np.asarray(map_pos)
        any_valid = valid.any(-1)
        for t, (color, thickness) in enumerate(LANE_STYLE):
            for i in np.where(mtype[:, t] & any_valid)[0]:
                col = color
                if attn_weights is not None and attn_weights[i] > 0:
                    col = tuple(float(x) * float(attn_weights[i]) for x in color)
                cv2.polylines(img, [self._to_px(pos[i][valid[i]][:, :2])], False,
                              col, thickness=max(1, thickness // 2), lineType=cv2.LINE_AA)
        return img

    # ------------------------------------------------------- traffic lights
    def draw_tl(self, img, tl_lane_valid=None, tl_lane_state=None, tl_lane_idx=None,
                tl_stop_valid=None, tl_stop_state=None, tl_stop_pos=None, tl_stop_dir=None):
        """Lane TLs: controlled lane polyline colored by state + end marker;
        stop TLs: arrowed line along the stop direction (vis_waymo.py:240-290)."""
        cv2 = require_cv2()
        if tl_lane_valid is not None:
            for i in np.where(np.asarray(tl_lane_valid, bool))[0]:
                li = int(tl_lane_idx[i])
                if li < 0:
                    continue
                state = int(np.argmax(tl_lane_state[i]))
                pts = self._to_px(self.map_pos[li][self.map_valid[li]][:, :2])
                cv2.polylines(img, [pts], False, TL_STYLE[state], 4, lineType=cv2.LINE_AA)
                if 1 <= state <= 3:
                    cv2.drawMarker(img, tuple(pts[-1]), TL_STYLE[state],
                                   markerType=cv2.MARKER_TILTED_CROSS, markerSize=8, thickness=3)
        if tl_stop_valid is not None:
            for i in np.where(np.asarray(tl_stop_valid, bool))[0]:
                state = int(np.argmax(tl_stop_state[i]))
                p0 = np.asarray(tl_stop_pos[i][:2], np.float64)
                p1 = p0 + 5.0 * np.asarray(tl_stop_dir[i][:2], np.float64)
                cv2.arrowedLine(img, tuple(self._to_px(p0[None])[0]), tuple(self._to_px(p1[None])[0]),
                                TL_STYLE[state], 2, line_type=cv2.LINE_AA, tipLength=0.3)
        return img

    # ----------------------------------------------------------- agent boxes
    def draw_agents(self, img, pose, valid, ag_size, ag_role=None, violation=None,
                    fill: bool = True):
        """Filled role-colored boxes + black heading arrow (vis_waymo.py:292-360);
        violated agents are outlined red on top."""
        cv2 = require_cv2()
        valid = np.asarray(valid, bool)
        pose = np.asarray(pose)
        corners_px = self._to_px(_agent_corners(pose, np.asarray(ag_size)))
        for a in np.where(valid)[0]:
            col = _role_color(None if ag_role is None else np.asarray(ag_role)[a])
            if fill:
                cv2.fillConvexPoly(img, corners_px[a], col)
            else:
                cv2.polylines(img, [corners_px[a]], True, col, 2)
            x, y, yaw = pose[a, :3]
            tip = np.array([[x, y], [x + 1.5 * np.cos(yaw), y + 1.5 * np.sin(yaw)]])
            t_px = self._to_px(tip)
            cv2.arrowedLine(img, tuple(t_px[0]), tuple(t_px[1]), COLOR_BLACK, 1,
                            line_type=cv2.LINE_AA, tipLength=0.6)
            if violation is not None and violation[a]:
                cv2.polylines(img, [corners_px[a]], True, COLOR_RED, 2)
        return img

    def draw_step(self, pose, valid, ag_size, ag_role=None, violation=None,
                  gt_pose=None, gt_valid=None, tl_kwargs: Optional[dict] = None):
        img = self.base.copy()
        if tl_kwargs:
            self.draw_tl(img, **tl_kwargs)
        if gt_pose is not None and gt_valid is not None:
            self.draw_agents(img, gt_pose, gt_valid, ag_size, ag_role, fill=False)
        self.draw_agents(img, pose, valid, ag_size, ag_role, violation)
        return img

    # -------------------------------------------------- agent-centric warp
    def agent_view(self, img: np.ndarray, loc_xy: np.ndarray, yaw: float,
                   view_size: int = 480) -> np.ndarray:
        """Rotate/crop so the agent looks 'up' (vis_waymo.py:526-543)."""
        cv2 = require_cv2()
        loc = self._to_px(np.asarray(loc_xy)[None])[0].astype(np.float64)
        fwd = np.array([np.cos(yaw), -np.sin(yaw)])
        right = np.array([np.sin(yaw), np.cos(yaw)])
        bottom = view_size // 2
        src = np.stack([
            loc - bottom * fwd - 0.5 * view_size * right,
            loc + (view_size - bottom) * fwd - 0.5 * view_size * right,
            loc + (view_size - bottom) * fwd + 0.5 * view_size * right,
        ]).astype(np.float32)
        dst = np.array([[0, view_size - 1], [0, 0], [view_size - 1, 0]], np.float32)
        return cv2.warpAffine(img, cv2.getAffineTransform(src, dst), (view_size, view_size))


def _write_video(path: str, frames: List[np.ndarray], fps: int) -> str:
    cv2 = require_cv2()
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    ok = writer.isOpened()
    if ok:
        for f in frames:
            writer.write(f[..., ::-1])  # RGB -> BGR
        writer.release()
        return str(path)
    # codec-free fallback: PNG frame dump
    out_dir = Path(str(path) + ".frames")
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(str(out_dir / f"{i:04d}.png"), f[..., ::-1])
    return str(out_dir)


def _sidebar(img: np.ndarray, lines: List[str], width: int = 200,
             line_h: int = 18) -> np.ndarray:
    cv2 = require_cv2()
    h, w = img.shape[:2]
    out = np.zeros((h, w + width, 3), img.dtype)
    out[:, :w] = img
    for i, txt in enumerate(lines):
        cv2.putText(out, txt, (w + 4, line_h * (i + 1)), cv2.FONT_HERSHEY_SIMPLEX,
                    0.45, COLOR_WHITE, 1)
    return out


def _txt_lines(prediction: Dict[str, np.ndarray], a: int, t: int) -> List[str]:
    """Per-step sidebar text (vis_waymo.py:452-512): violation this/cumulative,
    bounded action, joint-future score, action log-prob, diffbar rewards."""
    lines = [f"valid:{int(prediction['agent/valid'][a, t])}"]
    if "ag_navi_valid" in prediction:
        lines.append(f"nav_valid:{int(prediction['ag_navi_valid'][a, t])}")
    for label, key in _TXT_VIOLATIONS:
        ks, kc = f"{key}_this_step", key
        if ks in prediction:
            cum = int(prediction[kc][a, : t + 1].any()) if kc in prediction else 0
            lines.append(f"{label}:{int(prediction[ks][a, t])}/{cum}")
    if "action" in prediction:
        lines.append(f"acc:{prediction['action'][a, t, 0]:.2f}")
        lines.append(f"steer:{prediction['action'][a, t, 1]:.2f}")
    if "score" in prediction:
        lines.append(f"score:{prediction['score'][a]:.2f}")
    if "act_P" in prediction:
        lines.append(f"act_P:{prediction['act_P'][a, t]:.2f}")
    if "diffbar_reward" in prediction:
        lines.append(f"dr:{prediction['diffbar_reward'][a, t]:.2f}")
    for k in ("r_imitation_pos", "r_imitation_rot", "r_imitation_spd", "r_traffic_rule_approx"):
        if k in prediction:
            lines.append(f"{k.split('_')[-1]}:{prediction[k][a, t]:.2f}")
    lines += ["yellow:gt dest", "magenta:gt goal"]
    return lines


def save_prediction_videos(
    video_base_name: str,
    episode: Dict[str, np.ndarray],
    prediction: Optional[Dict[str, np.ndarray]] = None,
    save_agent_view: bool = True,
    n_others_to_vis: int = 5,
    fps: int = 10,
) -> List[str]:
    """gt / pd / mix videos + agent-centric sdc/predict/other views
    (vis_waymo.py:177-448).

    episode keys: map/{valid,type,pos,boundary}, agent/{valid,pos,yaw_bbox,
    role,size}; optional tl_lane/{valid,state,idx}, tl_stop/{valid,state,pos,
    dir}, agent/{dest,goal}.
    prediction keys (steps step_current+1..step_end): agent/{valid,pos,
    yaw_bbox}, step_current, step_gt, step_end; optional tl_lane/state,
    tl_stop/state, action, act_P, score, violation counters, rewards.
    """
    cv2 = require_cv2()
    r = SceneRenderer(episode["map/valid"], episode["map/type"], episode["map/pos"],
                      episode["map/boundary"])
    role = np.asarray(episode["agent/role"], bool)
    size = np.asarray(episode["agent/size"])

    videos: Dict[str, list] = {f"{video_base_name}-gt.mp4": [[], None]}
    if prediction is not None:
        step_current = int(prediction["step_current"])
        step_gt = int(prediction["step_gt"])
        step_end = int(prediction["step_end"])
        videos[f"{video_base_name}-pd.mp4"] = [[], None]
        videos[f"{video_base_name}-mix.mp4"] = [[], None]
        if save_agent_view:
            sdc = np.where(role[:, 0])[0]
            if len(sdc):
                videos[f"{video_base_name}-sdc.mp4"] = [[], int(sdc[0])]
            for i in np.where(role[:, 2])[0]:
                videos[f"{video_base_name}-pre_{i}.mp4"] = [[], int(i)]
            others = np.where(np.asarray(prediction["agent/valid"]).any(1) & ~role.any(1))[0]
            for i in others[:n_others_to_vis]:
                videos[f"{video_base_name}-other_{i}.mp4"] = [[], int(i)]
    else:
        step_end = episode["agent/valid"].shape[1] - 1
        step_gt = step_end
        step_current = step_end

    def ep_pose(t):
        return np.concatenate([episode["agent/pos"][:, t, :2],
                               episode["agent/yaw_bbox"][:, t, :1]], -1)

    def tl_kwargs(t, t_pred):
        # NOTE: for t beyond step_current the single shared base frame (gt, pd
        # AND mix videos) shows the model's PREDICTED TL states — matching the
        # reference exactly (vis_waymo.py:240-252 builds one step_image with
        # prediction TLs and derives all per-video frames from it)
        kw = {}
        if "tl_lane/valid" in episode:
            if t_pred < 0:
                kw.update(tl_lane_valid=episode["tl_lane/valid"][:, t],
                          tl_lane_state=episode["tl_lane/state"][:, t])
            elif prediction is not None and "tl_lane/state" in prediction:
                kw.update(tl_lane_valid=episode["tl_lane/valid"].any(-1),
                          tl_lane_state=prediction["tl_lane/state"][:, t_pred])
            if "tl_lane_valid" in kw:
                kw["tl_lane_idx"] = episode["tl_lane/idx"]
        if "tl_stop/valid" in episode:
            if t_pred < 0:
                kw.update(tl_stop_valid=episode["tl_stop/valid"][:, t],
                          tl_stop_state=episode["tl_stop/state"][:, t])
            elif prediction is not None and "tl_stop/state" in prediction:
                kw.update(tl_stop_valid=episode["tl_stop/valid"].any(-1),
                          tl_stop_state=prediction["tl_stop/state"][:, t_pred])
            if "tl_stop_valid" in kw:
                kw.update(tl_stop_pos=episode["tl_stop/pos"], tl_stop_dir=episode["tl_stop/dir"])
        return kw

    for t in range(step_end + 1):
        t_pred = t - step_current - 1
        base = r.base.copy()
        r.draw_tl(base, **tl_kwargs(t, t_pred))

        # gt frame + blend layer of gt boxes (for the mix video)
        frame_gt, blend_gt = base.copy(), np.zeros_like(base)
        if t <= step_gt:
            v = np.asarray(episode["agent/valid"][:, t], bool)
            r.draw_agents(frame_gt, ep_pose(t), v, size, role)
            r.draw_agents(blend_gt, ep_pose(t), v, size, role)
        videos[f"{video_base_name}-gt.mp4"][0].append(frame_gt)

        if prediction is None:
            continue
        if t_pred >= 0:
            frame_pd = base.copy()
            pd_pose = np.concatenate([prediction["agent/pos"][:, t_pred, :2],
                                      prediction["agent/yaw_bbox"][:, t_pred, :1]], -1)
            pd_valid = np.asarray(prediction["agent/valid"][:, t_pred], bool)
            r.draw_agents(frame_pd, pd_pose, pd_valid, size, role)
            frame_mix = cv2.addWeighted(blend_gt, 0.6, frame_pd, 1.0, 0)
        else:
            frame_pd = frame_gt.copy()
            frame_mix = frame_gt.copy()
        videos[f"{video_base_name}-pd.mp4"][0].append(frame_pd)
        videos[f"{video_base_name}-mix.mp4"][0].append(frame_mix)

        # agent-centric views with navi arrows + text sidebar
        for name, (frames, a) in videos.items():
            if a is None:
                continue
            if t_pred < 0:
                t_v = t if episode["agent/valid"][a, t] else int(np.argmax(episode["agent/valid"][a]))
                loc = episode["agent/pos"][a, t_v, :2]
                yaw = float(episode["agent/yaw_bbox"][a, t_v, 0])
                view = frame_mix.copy()
                lines = [f"valid:{int(episode['agent/valid'][a, t])}"]
            else:
                pv = np.asarray(prediction["agent/valid"][a], bool)
                if pv[t_pred]:
                    t_v = t_pred
                elif pv.any():  # closest valid step (vis_waymo.py:381-385)
                    valid_steps = np.where(pv)[0]
                    t_v = int(valid_steps[np.abs(valid_steps - t_pred).argmin()])
                else:
                    t_v = 0
                loc = prediction["agent/pos"][a, t_v, :2]
                yaw = float(prediction["agent/yaw_bbox"][a, t_v, 0])
                view = frame_mix.copy()
                loc_px = tuple(r._to_px(np.asarray(loc)[None])[0])
                if "agent/dest" in episode:  # gt dest arrow (butter)
                    d = int(episode["agent/dest"][a])
                    tgt = tuple(r._to_px(episode["map/pos"][d, 0, :2][None])[0])
                    cv2.arrowedLine(view, loc_px, tgt, COLOR_BUTTER_0, 2,
                                    line_type=cv2.LINE_AA, tipLength=0.05)
                if "agent/goal" in episode:  # gt goal arrow (magenta)
                    tgt = tuple(r._to_px(episode["agent/goal"][a, :2][None])[0])
                    cv2.arrowedLine(view, loc_px, tgt, COLOR_MAGENTA, 2,
                                    line_type=cv2.LINE_AA, tipLength=0.05)
                lines = _txt_lines(prediction, a, t_v)
            warped = r.agent_view(view, loc, yaw)
            frames.append(_sidebar(warped, lines))

    written = []
    for name, (frames, _) in videos.items():
        if frames:
            written.append(_write_video(name, frames, fps))
    return written


def save_rollout_video(
    path: str,
    map_valid, map_type, map_pos, map_boundary,
    pred_pose: np.ndarray,  # [n_ag, n_step, 3]
    pred_valid: np.ndarray,  # [n_ag, n_step]
    ag_size: np.ndarray,
    ag_role: Optional[np.ndarray] = None,
    violation: Optional[np.ndarray] = None,  # [n_ag, n_step]
    gt_pose: Optional[np.ndarray] = None,  # [n_ag, n_step, 3]
    gt_valid: Optional[np.ndarray] = None,
    fps: int = 10,
) -> str:
    """Render an mp4 of one rollout (compact single-video API)."""
    r = SceneRenderer(map_valid, map_type, map_pos, map_boundary)
    frames = []
    for t in range(pred_pose.shape[1]):
        frames.append(r.draw_step(
            pred_pose[:, t], pred_valid[:, t], ag_size, ag_role,
            None if violation is None else violation[:, t],
            None if gt_pose is None else gt_pose[:, t],
            None if gt_valid is None else gt_valid[:, t],
        ))
    return _write_video(path, frames, fps)


def dest_prob_image(
    map_valid, map_type, map_pos, map_boundary,
    dest_probs: np.ndarray,  # [n_mp] probability per polyline
    agent_pose: Optional[np.ndarray] = None,  # [3]
    agent_size: Optional[np.ndarray] = None,  # [>=2]
    gt_dest: Optional[int] = None,
) -> np.ndarray:
    """Destination-distribution heatmap (vis_waymo.py:570-643): probabilities
    normalized to [0, 3] scale the lane brightness, the top-6 polylines are
    re-styled (bike-lane color), the gt dest is overlaid magenta and the
    agent is drawn as a filled red box."""
    cv2 = require_cv2()
    r = SceneRenderer(map_valid, map_type, map_pos, map_boundary)
    p = np.asarray(dest_probs, np.float64)
    sel = p > 1e-4
    weights = np.zeros_like(p)
    if sel.any():
        q = p[sel]
        weights[sel] = (q - q.min()) / (q.max() - q.min() + 1e-4) * 3.0
    # heat style: everything SURFACE_STREET, top-6 as BIKE_LANE (vis_waymo.py:600-607)
    m_type = np.zeros((p.shape[0], len(LANE_STYLE)), bool)
    m_type[:, 1] = True
    for k in np.argsort(p)[-6:]:
        m_type[k] = False
        m_type[k, 3] = True
    img = r.draw_map(np.zeros_like(r.base), map_valid=np.asarray(map_valid) & sel[:, None],
                     map_type=m_type, attn_weights=weights)
    if gt_dest is not None:
        mv = np.asarray(map_valid, bool)[gt_dest]
        nodes = np.asarray(map_pos)[gt_dest][mv][:, :2]
        if len(nodes) >= 2:
            cv2.polylines(img, [r._to_px(nodes)], False, COLOR_MAGENTA, 2, lineType=cv2.LINE_AA)
    if agent_pose is not None:
        pose = np.asarray(agent_pose, np.float64)[None]
        size = np.asarray(agent_size)[None] if agent_size is not None else np.array([[4.0, 2.0]])
        cv2.fillConvexPoly(img, r._to_px(_agent_corners(pose, size))[0], COLOR_RED)
    return img


def get_dest_prob_images(
    im_base_name: str,
    episode: Dict[str, np.ndarray],
    dest_prob: np.ndarray,  # [n_ag, n_mp]
    n_others_to_vis: int = 5,
) -> List[str]:
    """Per-role heatmap images like the reference (vis_waymo.py:570-598):
    sdc + interest + predict + first 5 other agents."""
    cv2 = require_cv2()
    role = np.asarray(episode["agent/role"], bool)
    targets = {}
    sdc = np.where(role[:, 0])[0]
    if len(sdc):
        targets[f"{im_base_name}-sdc.jpg"] = int(sdc[0])
    for i in np.where(role[:, 1])[0]:
        targets[f"{im_base_name}-int_{i}.jpg"] = int(i)
    for i in np.where(role[:, 2])[0]:
        targets[f"{im_base_name}-pre_{i}.jpg"] = int(i)
    others = np.where(np.asarray(episode["agent/valid"]).any(1) & ~role.any(1))[0]
    for i in others[:n_others_to_vis]:
        targets[f"{im_base_name}-other_{i}.jpg"] = int(i)

    written = []
    for path, a in targets.items():
        t = int(np.argmax(episode["agent/valid"][a]))
        pose = np.concatenate([episode["agent/pos"][a, t, :2], episode["agent/yaw_bbox"][a, t, :1]])
        img = dest_prob_image(
            episode["map/valid"], episode["map/type"], episode["map/pos"],
            episode["map/boundary"], dest_prob[a],
            agent_pose=pose, agent_size=episode["agent/size"][a],
            gt_dest=int(episode["agent/dest"][a]) if "agent/dest" in episode else None,
        )
        cv2.imwrite(path, img[..., ::-1])
        written.append(path)
    return written
