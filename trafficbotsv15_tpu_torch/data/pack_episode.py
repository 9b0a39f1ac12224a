"""Offline ETL: pack a WOMD scenario into the fixed-shape h5 episode schema
(counterpart of `trafficbotsv15_tpu/data/pack_episode.py`, kept as the port's own copy).

Pure numpy (scipy interp1d replaced by np.interp per dim), the reference
packer's pipeline (pack_h5.py, 995 LoC numpy/scipy):

  pack_episode_map -> pack_episode_traffic_lights -> pack_episode_agents
  -> center_at_sdc (random augmentation) -> filter_episode_map
  -> repack_episode_map -> filter/repack traffic lights
  -> filter_episode_agents -> repack_episode_agents (interpolation + dest)
  -> get_map_boundary

Function names and signatures are the JAX package's, so that
`tests/etl_parity_common.py::run_pipeline` runs either module. The
TFRecord/proto parsing and the h5 writer live in `data/pack_h5_womd.py`
(gated on the waymo_open_dataset package); everything here runs without it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

N_AG_CMD = 8

# WOMD lane-type dims used in filtering (data/pack_h5_womd.py constants)
DIM_VEH_LANES = [0, 1, 2]
DIM_CYC_LANES = [3]
DIM_PED_LANES = [4]


def _rot2d(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]])


def cast_rad(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


# --------------------------------------------------------------------- pack
def pack_episode_map(episode, mp_id, mp_xyz, mp_type, mp_edge, n_mp_data, n_nodes=20) -> int:
    """Split polylines into <= n_nodes segments (pack_h5.py:19-63)."""
    episode["map/valid"] = np.zeros([n_mp_data, n_nodes], bool)
    episode["map/id"] = np.zeros([n_mp_data], np.int64) - 1
    episode["map/type"] = np.zeros([n_mp_data], np.int64)
    episode["map/pos"] = np.zeros([n_mp_data, n_nodes, 3], np.float32)
    episode["map/dir"] = np.zeros([n_mp_data, n_nodes, 3], np.float32)
    episode["map/edge"] = np.asarray(mp_edge) if len(mp_edge) else np.zeros([0, 2], np.int64)

    c = 0
    for i in range(len(mp_id)):
        pos = np.asarray(mp_xyz[i], np.float32).reshape(-1, 3)
        # NOTE: a 1-point polyline still CONSUMES a slot in the reference
        # (pack_h5.py:43-63 runs one cut with an empty range: valid stays all-
        # False but type/id are set and the counter advances) — mirrored here;
        # the degenerate_pl ETL golden pins it
        vec = np.diff(pos, axis=0)
        n = len(vec)
        cuts = np.linspace(0, n, n // n_nodes + 1, dtype=int, endpoint=False)
        for j, start in enumerate(cuts):
            end = n if j + 1 == len(cuts) else cuts[j + 1]
            episode["map/valid"][c, : end - start] = True
            episode["map/pos"][c, : end - start] = pos[start:end]
            episode["map/dir"][c, : end - start] = vec[start:end]
            episode["map/type"][c] = mp_type[i]
            episode["map/id"][c] = mp_id[i]
            c += 1
    return c


def pack_episode_traffic_lights(
    episode, step_current, tl_lane_state, tl_lane_id, tl_stop_point, pack_all, pack_history, n_tl_data
) -> int:
    """Track untracked tl observations by unique lane id (pack_h5.py:66-115)."""
    ids = np.unique([x for step in tl_lane_id for x in step]) if any(tl_lane_id) else np.array([], np.int64)
    data_id = np.zeros([n_tl_data], np.int64) - 1
    id2k = {int(v): k for k, v in enumerate(ids)}
    data_id[: len(ids)] = ids

    n_step = len(tl_lane_state)
    valid = np.zeros([n_tl_data, n_step], bool)
    state = np.zeros([n_tl_data, n_step], np.int64)
    stop_pos = np.zeros([n_tl_data, 3], np.float32)
    for t in range(n_step):
        for i, lane in enumerate(tl_lane_id[t]):
            k = id2k[int(lane)]
            valid[k, t] = True
            state[k, t] = tl_lane_state[t][i]
            if (stop_pos[k] == 0).all():
                stop_pos[k] = np.asarray(tl_stop_point[t][i])
    if pack_all:
        episode["tl_lane/id"] = data_id.copy()
        episode["tl_stop/pos"] = stop_pos.copy()
        episode["tl_lane/valid"] = valid.copy()
        episode["tl_lane/state"] = state.copy()
    if pack_history:
        episode["history/tl_lane/id"] = data_id.copy()
        episode["history/tl_stop/pos"] = stop_pos.copy()
        episode["history/tl_lane/valid"] = valid[:, : step_current + 1].copy()
        episode["history/tl_lane/state"] = state[:, : step_current + 1].copy()
    return len(id2k)


def classify_track(valid, pos, yaw, spd) -> int:
    """Waymo trajectory-type taxonomy port (pack_h5.py:933-995)."""
    k_max_spd, k_max_disp = 2.0, 5.0
    k_max_lat, k_min_lon_uturn, k_max_heading = 5.0, -5.0, 0.5236
    i0 = int(valid.argmax())
    i1 = len(valid) - 1 - int(np.flip(valid).argmax())
    x, y = pos[i1] - pos[i0]
    disp = np.hypot(x, y)
    c, s = np.cos(-yaw[i0]), np.sin(-yaw[i0])
    dx, dy = x * c - y * s, x * s + y * c
    heading_diff = yaw[i1] - yaw[i0]
    if max(spd[i0], spd[i1]) < k_max_spd and disp < k_max_disp:
        return 0
    if abs(heading_diff) < k_max_heading:
        if abs(dy) < k_max_lat:
            return 1
        return 2 if dy > 0 else 3
    if heading_diff < -k_max_heading and dy < 0:
        return 6 if dx < k_min_lon_uturn else 7
    if dx < k_min_lon_uturn:
        return 4
    return 5


def pack_episode_agents(
    episode, step_current, ag_id, ag_type, ag_state, ag_role, pack_all, pack_history, n_ag_data, n_ag_type=3
) -> int:
    """Agent state packing + goal extraction + sdc-first swap (pack_h5.py:118-235)."""
    n_step = len(ag_state[0])
    d = {
        "valid": np.zeros([n_ag_data, n_step], bool),
        "pos": np.zeros([n_ag_data, n_step, 3], np.float32),
        "vel": np.zeros([n_ag_data, n_step, 2], np.float32),
        "spd": np.zeros([n_ag_data, n_step, 1], np.float32),
        "yaw_bbox": np.zeros([n_ag_data, n_step, 1], np.float32),
        "type": np.zeros([n_ag_data, n_ag_type], bool),
        "cmd": np.zeros([n_ag_data, N_AG_CMD], bool),
        "role": np.zeros([n_ag_data, len(ag_role[0])], bool),
        "size": np.zeros([n_ag_data, 3], np.float32),
        "goal": np.zeros([n_ag_data, 4], np.float32),
        "object_id": np.zeros([n_ag_data], np.int64) - 1,
    }
    for i in range(len(ag_id)):
        d["type"][i, ag_type[i]] = True
        d["object_id"][i] = ag_id[i]
        d["role"][i] = ag_role[i]
        # vectorized over the step axis (the reference loops python steps,
        # pack_h5.py:140-163); float64 math with the same rounding points, so
        # results stay bit-identical to the scalar loop
        st = np.asarray(ag_state[i], np.float64)  # [n_step, 10]
        v = st[:, 9].astype(bool)
        d["valid"][i] = v
        d["pos"][i, v] = st[v, 0:3]
        d["yaw_bbox"][i, v, 0] = st[v, 6]
        d["vel"][i, v] = st[v, 7:9]
        spd = np.sign(np.cos(st[:, 6]) * st[:, 7] + np.sin(st[:, 6]) * st[:, 8]) * np.hypot(
            st[:, 7], st[:, 8])
        d["spd"][i, v, 0] = spd[v]
        if v.any():
            last = int(np.where(v)[0][-1])
            # goal x/y/spd read back through the float32 arrays in the loop
            # formulation — keep the same double-rounding
            d["goal"][i] = [np.float32(st[last, 0]), np.float32(st[last, 1]),
                            st[last, 6], np.float32(spd[last])]
            # cumsum accumulates sequentially in step order — the same float64
            # rounding sequence as the replaced loop's `lwh += st[3:6]` (a
            # pairwise .sum(0) could differ by an ulp over many steps)
            d["size"][i] = np.cumsum(st[v, 3:6], axis=0)[-1] / v.sum()
        cmd = classify_track(
            d["valid"][i, step_current:], d["pos"][i, step_current:, :2],
            d["yaw_bbox"][i, step_current:, 0], d["spd"][i, step_current:, 0],
        )
        d["cmd"][i, cmd] = True

    sdc = int(np.where(d["role"][:, 0])[0][0])
    for k in d:
        d[k][[0, sdc]] = d[k][[sdc, 0]]

    if pack_all:
        for k in ("valid", "pos", "vel", "spd", "yaw_bbox", "object_id", "type", "role", "size", "cmd", "goal"):
            episode[f"agent/{k}"] = d[k].copy()
    if pack_history:
        for k in ("valid", "pos", "vel", "spd", "yaw_bbox"):
            episode[f"history/agent/{k}"] = d[k][:, : step_current + 1].copy()
        for k in ("object_id", "type", "role", "size"):
            episode[f"history/agent/{k}"] = d[k].copy()
        invalid = ~episode["history/agent/valid"].any(1)
        episode["history/agent/object_id"][invalid] = -1
        episode["history/agent/type"][invalid] = False
        episode["history/agent/size"][invalid] = 0
    return len(ag_id)


# ------------------------------------------------------------- recenter/aug
def center_at_sdc(episode, step_current, rand_pos: float = -1, rand_yaw: float = -1,
                  rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, float]:
    """SDC-centric recentring with random pos/yaw augmentation (pack_h5.py:236-304)."""
    rng = rng or np.random.default_rng()
    prefix = [p for p, k in (("", "agent/pos"), ("history/", "history/agent/valid")) if k in episode]

    center = episode[prefix[0] + "agent/pos"][0, step_current, :2].copy()
    yaw = float(episode[prefix[0] + "agent/yaw_bbox"][0, step_current, 0])
    if rand_pos > 0:
        center += rng.uniform(-rand_pos, rand_pos, 2)
    if rand_yaw > 0:
        yaw += float(rng.uniform(-rand_yaw, rand_yaw))

    rot = _rot2d(-yaw)  # world -> sdc
    # the reference derives the additive yaw from the rotation matrix
    # (transform_utils.get_yaw_from_se2 -> atan2), i.e. -yaw WRAPPED into
    # (-pi, pi]; identical to -yaw unless augmentation pushes |yaw| > pi
    # (the aug ETL golden pins this)
    yaw_add = float(np.arctan2(np.sin(-yaw), np.cos(-yaw)))

    def to_local_pts(pts):  # [N, 2]
        return (pts - center) @ rot.T

    def to_local_vec(vec):
        return vec @ rot.T

    m = episode["map/valid"]
    episode["map/pos"][..., :2][m] = to_local_pts(episode["map/pos"][..., :2][m])
    episode["map/dir"][..., :2][m] = to_local_vec(episode["map/dir"][..., :2][m])

    for pf in prefix:
        v = episode[pf + "agent/valid"]
        episode[pf + "agent/pos"][..., :2][v] = to_local_pts(episode[pf + "agent/pos"][..., :2][v])
        episode[pf + "agent/vel"][v] = to_local_vec(episode[pf + "agent/vel"][v])
        episode[pf + "agent/yaw_bbox"][v] += yaw_add
        key_tl = pf + "tl_stop/pos"
        if key_tl in episode:
            tv = episode[pf + "tl_lane/valid"].any(1)
            episode[key_tl][..., :2][tv] = to_local_pts(episode[key_tl][..., :2][tv])
        if pf == "":
            gv = episode["agent/valid"].any(1)
            episode["agent/goal"][..., :2][gv] = to_local_pts(episode["agent/goal"][..., :2][gv])
            episode["agent/goal"][..., 2][gv] += yaw_add
    return center, yaw


# ------------------------------------------------------------------ filters
def filter_episode_map(episode, step_current, n_mp_h5, dist_thresh_mp=2000.0, thresh_z=-1.0):
    """Distance-based map reduction to <= n_mp_h5 polylines (pack_h5.py:307-381)."""
    if "agent/valid" in episode:
        rel = episode["agent/role"].any(-1)
        v = episode["agent/valid"][rel, : step_current + 1]
        p = episode["agent/pos"][rel, : step_current + 1]
    else:
        rel = episode["history/agent/role"].any(-1)
        v = episode["history/agent/valid"][rel]
        p = episode["history/agent/pos"][rel]
    rel_pos = p[v]  # [N, 3]

    xmin, xmax = rel_pos[:, 0].min(), rel_pos[:, 0].max()
    ymin, ymax = rel_pos[:, 1].min(), rel_pos[:, 1].max()
    xt, yt = max(xmax - xmin, dist_thresh_mp), max(ymax - ymin, dist_thresh_mp)
    old = episode["map/valid"].copy()
    mv = episode["map/valid"]
    px, py = episode["map/pos"][..., 0], episode["map/pos"][..., 1]
    keep = (
        (px > xmin - xt).any(-1, keepdims=True) & (px < xmax + xt).any(-1, keepdims=True)
        & (py > ymin - yt).any(-1, keepdims=True) & (py < ymax + yt).any(-1, keepdims=True)
    )
    episode["map/valid"] = mv & keep
    if thresh_z > 0:
        zmin, zmax = rel_pos[:, 2].min(), rel_pos[:, 2].max()
        zt = max(zmax - zmin, thresh_z)
        pz = episode["map/pos"][..., 2]
        episode["map/valid"] &= (pz > zmin - zt).any(-1, keepdims=True) & (pz < zmax + zt).any(-1, keepdims=True)
    if episode["map/valid"].any(1).sum() < 10:
        episode["map/valid"] = old

    episode["map/valid"][episode["map/valid"].sum(1) <= 3] = False

    while episode["map/valid"].any(1).sum() > n_mp_h5:
        remain = episode["map/valid"].any(1)
        for i in range(len(remain)):
            if remain[i]:
                # 3-D distance, matching pack_h5.py:372-376 bit for bit
                pl = episode["map/pos"][i][episode["map/valid"][i]]
                close = min(
                    np.linalg.norm(rel_pos - pl[0], axis=1).min(),
                    np.linalg.norm(rel_pos - pl[-1], axis=1).min(),
                ) < dist_thresh_mp
                if not close:
                    episode["map/valid"][i] = False
                if episode["map/valid"].any(1).sum() == n_mp_h5:
                    break
        dist_thresh_mp *= 0.5


def repack_episode_map(episode, episode_reduced, n_mp_h5, n_mp_type):
    """Compact valid polylines + one-hot type (pack_h5.py:384-412)."""
    n_node = episode["map/valid"].shape[1]
    er = episode_reduced
    er["map/valid"] = np.zeros([n_mp_h5, n_node], bool)
    er["map/type"] = np.zeros([n_mp_h5], np.int64)
    er["map/pos"] = np.zeros([n_mp_h5, n_node, 3], np.float32)
    er["map/dir"] = np.zeros([n_mp_h5, n_node, 3], np.float32)
    er["map/id"] = np.zeros([n_mp_h5], np.int64) - 1
    m = episode["map/valid"].any(1)
    n = int(m.sum())
    for k in ("valid", "type", "pos", "dir", "id"):
        er[f"map/{k}"][:n] = episode[f"map/{k}"][m]
    er["map/type"] = np.eye(n_mp_type, dtype=bool)[er["map/type"]]
    er["map/type"] &= er["map/valid"].any(-1, keepdims=True)
    return n


def filter_episode_traffic_lights(episode):
    """Drop tl entries whose lane was filtered out (pack_h5.py:415-435).
    One [n_tl, n_mp] id-match matmul against per-polyline valid-node counts
    replaces the reference's per-entry boolean scans."""
    valid_nodes = episode["map/valid"].sum(1)  # [n_mp_data]
    for pf in [p for p in ("", "history/") if p + "tl_lane/valid" in episode]:
        lane_ids = np.asarray(episode[pf + "tl_lane/id"])
        dead = (episode["map/id"][None, :] == lane_ids[:, None]) @ valid_nodes == 0
        episode[pf + "tl_lane/valid"][dead] = False


def repack_episode_traffic_lights(episode, episode_reduced, n_tl_lane_h5, n_tl_state):
    """Expand tl tracks to per-polyline entries + one-hot states (pack_h5.py:438-516)."""
    er = episode_reduced
    n_max = 0
    for pf in [p for p in ("", "history/") if p + "tl_lane/valid" in episode]:
        n_tl_data, n_step = episode[pf + "tl_lane/valid"].shape
        er[pf + "tl_lane/idx"] = np.zeros([n_tl_lane_h5], np.int64) - 1
        er[pf + "tl_lane/valid"] = np.zeros([n_tl_lane_h5, n_step], bool)
        er[pf + "tl_lane/state"] = np.zeros([n_tl_lane_h5, n_step], np.int64)
        er[pf + "tl_stop/valid"] = np.zeros([n_tl_data, n_step], bool)
        er[pf + "tl_stop/state"] = np.zeros([n_tl_data, n_step], np.int64)
        er[pf + "tl_stop/pos"] = np.zeros([n_tl_data, 3], np.float32)
        er[pf + "tl_stop/dir"] = np.zeros([n_tl_data, 3], np.float32)
        c_lane = c_stop = 0
        for i in range(n_tl_data):
            lane_idx = np.where(er["map/id"] == episode[pf + "tl_lane/id"][i])[0]
            if episode[pf + "tl_lane/valid"][i].any() and len(lane_idx):
                n_l = len(lane_idx)
                assert c_lane + n_l <= n_tl_lane_h5
                er[pf + "tl_lane/valid"][c_lane : c_lane + n_l] = episode[pf + "tl_lane/valid"][i]
                er[pf + "tl_lane/state"][c_lane : c_lane + n_l] = episode[pf + "tl_lane/state"][i]
                er[pf + "tl_lane/idx"][c_lane : c_lane + n_l] = lane_idx
                c_lane += n_l
                er[pf + "tl_stop/valid"][c_stop] = episode[pf + "tl_lane/valid"][i]
                er[pf + "tl_stop/state"][c_stop] = episode[pf + "tl_lane/state"][i]
                er[pf + "tl_stop/pos"][c_stop] = episode[pf + "tl_stop/pos"][i]
                er[pf + "tl_stop/dir"][c_stop] = er["map/dir"][lane_idx[0], 0]
                c_stop += 1
        er[pf + "tl_lane/state"] = np.eye(n_tl_state, dtype=bool)[er[pf + "tl_lane/state"]]
        er[pf + "tl_lane/state"] &= er[pf + "tl_lane/valid"][:, :, None]
        er[pf + "tl_stop/state"] = np.eye(n_tl_state, dtype=bool)[er[pf + "tl_stop/state"]]
        er[pf + "tl_stop/state"] &= er[pf + "tl_stop/valid"][:, :, None]
        n_max = max(n_max, c_lane)
    return n_max


def filter_episode_agents(
    episode, episode_reduced, step_current, n_ag_h5_sim, dist_thresh_ag=120.0,
    dim_veh_lanes=DIM_VEH_LANES, prefix="",
):
    """Reduce to <= n_ag_h5_sim agents with the reference's heuristics
    (pack_h5.py:519-659): unseen-in-history, short tracks, still & far,
    off-lane parked vehicles, yaw-jump outliers, then distance threshold."""
    ag_valid = episode[prefix + "agent/valid"].copy()
    n_ag_data = ag_valid.shape[0]
    rel = episode[prefix + "agent/role"].any(-1)
    rel_xy = episode[prefix + "agent/pos"][rel][episode[prefix + "agent/valid"][rel]][:, :2]
    thresh_spd = 2 if prefix == "" else 0.5

    not_seen = (~rel) & ~ag_valid[:, : step_current + 1].any(1)
    ag_valid &= ~not_seen[:, None]
    if prefix == "":
        short = (~rel) & (ag_valid.sum(1) < 20)
        ag_valid &= ~short[:, None]

    still = (episode[prefix + "agent/spd"][..., 0].sum(1) * 0.1 < thresh_spd) & (~rel) & ag_valid.any(1)
    lane_pos = episode_reduced["map/pos"][episode_reduced["map/valid"], :2]
    # the reference's parked-vehicle loop (pack_h5.py:611-613) reads
    # start_pos/end_pos LEFT OVER from this still-agent loop — a stale-variable
    # bug it ships with; bit-parity means replicating it (stale_start/stale_end
    # below), caught by the still_agents ETL golden. If the still loop body
    # never ran the reference would NameError (out-of-contract input); we fall
    # back to the current agent's poses there.
    stale_start = stale_end = None
    for i in range(n_ag_data):
        if still[i] and ag_valid.any(1).sum() > n_ag_h5_sim:
            poses = episode[prefix + "agent/pos"][i, :, :2][ag_valid[i]]
            stale_start, stale_end = poses[0], poses[-1]
            far_agent = (np.linalg.norm(rel_xy - poses[0], axis=-1).min() > 20) and (
                np.linalg.norm(rel_xy - poses[-1], axis=-1).min() > 20)
            far_lane = (np.linalg.norm(lane_pos - poses[0], axis=-1).min() > 20) and (
                np.linalg.norm(lane_pos - poses[-1], axis=-1).min() > 20)
            if far_agent and far_lane:
                ag_valid[i] = False

    # parked vehicles off-lane
    mask_veh_lane = episode_reduced["map/type"][:, dim_veh_lanes].any(-1, keepdims=True) & episode_reduced["map/valid"]
    pos_vl = episode_reduced["map/pos"][mask_veh_lane, :2]
    dir_vl = episode_reduced["map/dir"][mask_veh_lane, :2]
    dir_vl = dir_vl / (np.linalg.norm(dir_vl, axis=-1, keepdims=True) + 1e-9)
    veh_still = (
        (episode[prefix + "agent/spd"][..., 0].sum(1) * 0.1 < thresh_spd) & (~rel)
        & ag_valid.any(1) & episode[prefix + "agent/type"][:, 0]
    )
    for i in range(n_ag_data):
        # NOTE: no len(pos_vl) guard — with ZERO veh-lane polylines in the
        # reduced map the reference still runs this body (empty candidate set
        # -> not_associate_to_lane=True) and drops far parked vehicles; the
        # far_map ETL golden pins that behavior
        if veh_still[i] and ag_valid.any(1).sum() > n_ag_h5_sim:
            poses = episode[prefix + "agent/pos"][i, :, :2][ag_valid[i]]
            yaw = episode[prefix + "agent/yaw_bbox"][i, :, 0][ag_valid[i]][-1]
            heading = np.array([np.cos(yaw), np.sin(yaw)])
            candidate = (np.linalg.norm(pos_vl - poses[-1], axis=-1) < 3) & (dir_vl @ heading > 0)
            # reference parity: the far-to-relevant check uses the STALE
            # start/end of the last still-loop agent, not this agent's
            # (pack_h5.py:611-613 stale-variable bug; see comment above)
            s = stale_start if stale_start is not None else poses[0]
            e = stale_end if stale_end is not None else poses[-1]
            far_agent = (np.linalg.norm(rel_xy - s, axis=1).min() > 10) and (
                np.linalg.norm(rel_xy - e, axis=1).min() > 10)
            if far_agent and not candidate.any():
                ag_valid[i] = False

    # yaw-jump outliers (training only)
    if prefix == "" and ag_valid.any(1).sum() > n_ag_h5_sim:
        yaw_diff = np.abs(cast_rad(np.diff(episode["agent/yaw_bbox"][..., 0], axis=1))) * (
            ag_valid[:, :-1] & ag_valid[:, 1:])
        max_yd = yaw_diff.max(1)
        spd_sum = episode["agent/spd"][..., 0].sum(1) * 0.1
        bad_veh = (((spd_sum < 6) & (max_yd > 0.5)) | (max_yd > 1.5)) & episode["agent/type"][:, 0]
        bad_pc = (((spd_sum < 1) & (max_yd > 0.5)) | (max_yd > 1.5)) & episode["agent/type"][:, 1:].any(-1)
        bad = (bad_veh | bad_pc) & (~rel) & ag_valid.any(1)
        ag_valid[bad] = False

    while ag_valid.any(1).sum() > n_ag_h5_sim:
        remain = (~rel) & ag_valid.any(1)
        for i in range(n_ag_data):
            if remain[i]:
                poses = episode[prefix + "agent/pos"][i, :, :2][ag_valid[i]]
                close = min(
                    np.linalg.norm(rel_xy - poses[0], axis=-1).min(),
                    np.linalg.norm(rel_xy - poses[-1], axis=-1).min(),
                ) < dist_thresh_ag
                if not close:
                    ag_valid[i] = False
                if ag_valid.any(1).sum() == n_ag_h5_sim:
                    break
        dist_thresh_ag *= 0.5

    mask_sim = ag_valid.any(1)
    mask_no_sim = episode[prefix + "agent/valid"].any(1) & ~mask_sim
    return mask_sim, mask_no_sim


def _interp_steps(valid: np.ndarray, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Linear interpolation over invalid gaps between first/last valid step."""
    steps = np.where(valid)[0]
    s0, s1 = steps[0], steps[-1]
    x = np.arange(s0, s1 + 1)
    flat = arr[valid].reshape(len(steps), -1)
    out = np.stack([np.interp(x, steps, flat[:, j]) for j in range(flat.shape[1])], axis=-1)
    return x, out.reshape((len(x),) + arr.shape[1:])


def repack_episode_agents(
    episode, episode_reduced, mask_sim, n_ag_h5_sim,
    dim_veh_lanes=DIM_VEH_LANES, dim_cyc_lanes=DIM_CYC_LANES, dim_ped_lanes=DIM_PED_LANES,
    dest_no_pred=False, prefix="", rng: Optional[np.random.Generator] = None,
):
    """Interpolate tracks, derive acc/yaw_rate, extract dest (pack_h5.py:662-797)."""
    rng = rng or np.random.default_rng()
    er = episode_reduced
    n_step = episode[prefix + "agent/valid"].shape[1]
    for k, shape, dt in (
        ("valid", (n_ag_h5_sim, n_step), bool),
        ("pos", (n_ag_h5_sim, n_step, 3), np.float32),
        ("vel", (n_ag_h5_sim, n_step, 2), np.float32),
        ("spd", (n_ag_h5_sim, n_step, 1), np.float32),
        ("acc", (n_ag_h5_sim, n_step, 1), np.float32),
        ("yaw_bbox", (n_ag_h5_sim, n_step, 1), np.float32),
        ("yaw_rate", (n_ag_h5_sim, n_step, 1), np.float32),
        ("type", (n_ag_h5_sim, 3), bool),
        ("role", (n_ag_h5_sim, episode[prefix + "agent/role"].shape[-1]), bool),
        ("size", (n_ag_h5_sim, 3), np.float32),
    ):
        er[prefix + f"agent/{k}"] = np.zeros(shape, dt)
    er[prefix + "agent/object_id"] = np.zeros([n_ag_h5_sim], np.int64) - 1
    if prefix == "":
        er["agent/cmd"] = np.zeros([n_ag_h5_sim, N_AG_CMD], bool)
        er["agent/goal"] = np.zeros([n_ag_h5_sim, 4], np.float32)
        er["agent/dest"] = np.zeros([n_ag_h5_sim], np.int64)
        n_mp, n_node = er["map/valid"].shape
        mask_vl = er["map/type"][:, dim_veh_lanes].any(-1, keepdims=True) & er["map/valid"]
        pos_vl, dir_vl = er["map/pos"][mask_vl, :2], er["map/dir"][mask_vl, :2]
        dir_vl = dir_vl / (np.linalg.norm(dir_vl, axis=-1, keepdims=True) + 1e-9)
        id_vl = np.repeat(er["map/id"][:, None], n_node, 1)[mask_vl]
        idx_vl = np.repeat(np.arange(n_mp)[:, None], n_node, 1)[mask_vl]
        mask_cl = er["map/type"][:, dim_cyc_lanes].any(-1, keepdims=True) & er["map/valid"]
        pos_cl, dir_cl = er["map/pos"][mask_cl, :2], er["map/dir"][mask_cl, :2]
        dir_cl = dir_cl / (np.linalg.norm(dir_cl, axis=-1, keepdims=True) + 1e-9)
        idx_cl = np.repeat(np.arange(n_mp)[:, None], n_node, 1)[mask_cl]
        mask_re = er["map/type"][:, dim_ped_lanes].any(-1, keepdims=True) & er["map/valid"]
        pos_re = er["map/pos"][mask_re, :2]
        idx_re = np.repeat(np.arange(n_mp)[:, None], n_node, 1)[mask_re]

    for i, idx in enumerate(np.where(mask_sim)[0]):
        valid = episode[prefix + "agent/valid"][idx]
        if valid.sum() > 1:
            steps = np.where(valid)[0]
            s0, s1 = steps[0], steps[-1]
            x, pos = _interp_steps(valid, episode[prefix + "agent/pos"][idx])
            _, vel = _interp_steps(valid, episode[prefix + "agent/vel"][idx])
            _, spd = _interp_steps(valid, episode[prefix + "agent/spd"][idx])
            yaw_unwrap = episode[prefix + "agent/yaw_bbox"][idx].copy()
            yaw_unwrap[valid] = np.unwrap(yaw_unwrap[valid], axis=0)
            _, yaw = _interp_steps(valid, yaw_unwrap)
            er[prefix + "agent/valid"][i, s0 : s1 + 1] = True
            er[prefix + "agent/pos"][i, s0 : s1 + 1] = pos
            er[prefix + "agent/vel"][i, s0 : s1 + 1] = vel
            er[prefix + "agent/spd"][i, s0 : s1 + 1] = spd
            er[prefix + "agent/yaw_bbox"][i, s0 : s1 + 1] = yaw
            er[prefix + "agent/acc"][i, s0 + 1 : s1 + 1] = np.diff(spd, axis=0) / 0.1
            er[prefix + "agent/yaw_rate"][i, s0 + 1 : s1 + 1] = np.diff(yaw, axis=0) / 0.1
        else:
            vs = np.where(valid)[0][0]
            er[prefix + "agent/valid"][i, vs] = True
            for k in ("pos", "vel", "spd", "yaw_bbox"):
                er[prefix + f"agent/{k}"][i, vs] = episode[prefix + f"agent/{k}"][idx, vs]
        for k in ("object_id", "type", "role", "size"):
            er[prefix + f"agent/{k}"][i] = episode[prefix + f"agent/{k}"][idx]
        if prefix == "":
            er["agent/goal"][i] = episode["agent/goal"][idx]
            er["agent/cmd"][i] = episode["agent/cmd"][idx]
            er["agent/dest"][i] = find_dest(
                er["agent/type"][i], er["agent/goal"][i], episode["map/edge"],
                pos_vl, dir_vl, id_vl, idx_vl, pos_cl, dir_cl, idx_cl, pos_re, idx_re,
                dest_no_pred, rng,
            )


def repack_episode_agents_no_sim(episode, episode_reduced, mask_no_sim, n_ag_h5_no_sim, prefix):
    """Pad-copy non-simulated agents (pack_h5.py:800-819)."""
    n_step = episode[prefix + "agent/valid"].shape[1]
    er = episode_reduced
    er[prefix + "agent_no_sim/valid"] = np.zeros([n_ag_h5_no_sim, n_step], bool)
    er[prefix + "agent_no_sim/pos"] = np.zeros([n_ag_h5_no_sim, n_step, 3], np.float32)
    er[prefix + "agent_no_sim/vel"] = np.zeros([n_ag_h5_no_sim, n_step, 2], np.float32)
    er[prefix + "agent_no_sim/spd"] = np.zeros([n_ag_h5_no_sim, n_step, 1], np.float32)
    er[prefix + "agent_no_sim/yaw_bbox"] = np.zeros([n_ag_h5_no_sim, n_step, 1], np.float32)
    er[prefix + "agent_no_sim/object_id"] = np.zeros([n_ag_h5_no_sim], np.int64) - 1
    er[prefix + "agent_no_sim/type"] = np.zeros([n_ag_h5_no_sim, 3], bool)
    er[prefix + "agent_no_sim/size"] = np.zeros([n_ag_h5_no_sim, 3], np.float32)
    for i, idx in enumerate(np.where(mask_no_sim)[0][:n_ag_h5_no_sim]):
        for k in ("valid", "pos", "vel", "spd", "yaw_bbox", "object_id", "type", "size"):
            er[prefix + f"agent_no_sim/{k}"][i] = episode[prefix + f"agent/{k}"][idx]


def get_polylines_from_polygon(polygon: np.ndarray) -> List[List[List[float]]]:
    """Speed-bump/crosswalk polygons -> interpolated polylines (pack_h5.py:822-849)."""
    l1 = np.linalg.norm(polygon[1, :2] - polygon[0, :2])
    l2 = np.linalg.norm(polygon[2, :2] - polygon[1, :2])

    def interp(start, end):
        length = np.linalg.norm(start - end)
        unit = (end - start) / max(length, 1e-9)
        pl = [list(start + unit * i) for i in range(int(length) + 1)]
        pl.append(list(end))
        return pl

    if l1 > l2:
        pl1, pl2 = interp(polygon[0], polygon[1]), interp(polygon[2], polygon[3])
    else:
        pl1, pl2 = interp(polygon[0], polygon[3]), interp(polygon[2], polygon[1])
    return [pl1, pl1[::-1], pl2, pl2[::-1]]


def get_map_boundary(map_valid, map_pos) -> np.ndarray:
    pos = map_pos[map_valid]
    return np.array([pos[:, 0].min(), pos[:, 0].max(), pos[:, 1].min(), pos[:, 1].max()])


def find_dest(
    agent_type, agent_goal, map_edge,
    pos_veh_lane, dir_veh_lane, map_id_veh_lane, pl_idx_veh_lane,
    pos_cyc_lane, dir_cyc_lane, pl_idx_cyc_lane,
    pos_road_edge, pl_idx_road_edge,
    no_pred=False, rng: Optional[np.random.Generator] = None,
) -> int:
    """Goal -> destination polyline index with random topology extension
    (pack_h5.py:868-930)."""
    rng = rng or np.random.default_rng()
    goal_yaw, goal_spd = agent_goal[2], agent_goal[3]
    heading = np.array([np.cos(goal_yaw), np.sin(goal_yaw)])
    goal_pos = agent_goal[:2]
    ext = goal_pos if no_pred else goal_pos + heading * goal_spd * 5

    def nearest_road_edge():
        if len(pos_road_edge) == 0:
            return 0
        return int(pl_idx_road_edge[np.linalg.norm(pos_road_edge - ext, axis=1).argmin()])

    if agent_type[0]:  # vehicle
        if len(pos_veh_lane) == 0:
            return nearest_road_edge()
        dist = np.linalg.norm(pos_veh_lane - goal_pos, axis=1)
        cand = (dist < 3) & (dir_veh_lane @ heading > 0)
        if cand.any():
            if no_pred:
                return int(pl_idx_veh_lane[cand][np.argmin(dist[cand])])
            dest_id = map_id_veh_lane[cand][np.argmin(dist[cand])]
            next_id, counter = dest_id, 0
            while True:
                nxt = np.where(map_edge[:, 0] == next_id)[0] if len(map_edge) else []
                if len(nxt) == 0:
                    break
                dest_id, next_id = map_edge[rng.choice(nxt)]
                counter += 1
                if (next_id not in map_id_veh_lane) or (len(nxt) > 1 and counter > 1) or counter > 3:
                    break
            matches = np.where(map_id_veh_lane == dest_id)[0]
            return int(pl_idx_veh_lane[matches[-1]]) if len(matches) else nearest_road_edge()
        return nearest_road_edge()
    if agent_type[1]:  # pedestrian
        return nearest_road_edge()
    # cyclist
    if len(pos_cyc_lane):
        dist = np.linalg.norm(pos_cyc_lane - ext, axis=1)
        cand = (dist < 3) & (dir_cyc_lane @ heading > 0)
        if cand.any():
            return int(pl_idx_cyc_lane[cand][np.argmin(dist[cand])])
    return nearest_road_edge()
