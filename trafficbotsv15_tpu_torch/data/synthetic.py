"""Synthetic WOMD-schema scenario generator.

Produces physically plausible random episodes matching the h5 data contract
(data_h5_womd.py:102-134): straight/curved lane polylines, agents driving
along smooth trajectories, tracked traffic lights. Used by unit tests and by
bench.py so the framework can be exercised without the (licensed) WOMD data.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from trafficbotsv15_tpu_torch.config import DataCfg


def make_batch(cfg: DataCfg, n_sc: int = 2, seed: int = 0, test_mode: bool = False) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_ag, n_step, n_mp, n_node = cfg.n_ag, cfg.n_step, cfg.n_mp, cfg.n_mp_pl_node
    n_tl = cfg.n_tl_lane
    dt = 0.1

    # --- map: polylines radiating from origin with gentle curvature
    mp_valid = np.zeros((n_sc, n_mp, n_node), bool)
    mp_pos = np.zeros((n_sc, n_mp, n_node, 3), np.float32)
    mp_dir = np.zeros((n_sc, n_mp, n_node, 3), np.float32)
    mp_type = np.zeros((n_sc, n_mp, cfg.n_mp_type), bool)
    n_mp_valid = max(4, int(n_mp * 0.6))
    for s in range(n_sc):
        for p in range(n_mp_valid):
            start = rng.uniform(-200, 200, 2)
            heading = rng.uniform(-np.pi, np.pi)
            curv = rng.uniform(-0.01, 0.01)
            n_valid_node = rng.integers(max(2, n_node // 2), n_node + 1)
            pt = start.copy()
            for i in range(n_valid_node):
                mp_valid[s, p, i] = True
                d = np.array([np.cos(heading), np.sin(heading)]) * 2.0
                mp_pos[s, p, i, :2] = pt
                mp_dir[s, p, i, :2] = d
                pt = pt + d
                heading += curv
            # first polylines cycle through all types so every dest-compatible
            # lane type exists; rest random
            t = p % cfg.n_mp_type if p < 2 * cfg.n_mp_type else rng.integers(0, cfg.n_mp_type)
            mp_type[s, p, t] = True

    # --- agents: smooth kinematic tracks
    ag_valid = np.zeros((n_sc, n_ag, n_step), bool)
    ag_pos = np.zeros((n_sc, n_ag, n_step, 3), np.float32)
    ag_vel = np.zeros((n_sc, n_ag, n_step, 2), np.float32)
    ag_spd = np.zeros((n_sc, n_ag, n_step, 1), np.float32)
    ag_acc = np.zeros((n_sc, n_ag, n_step, 1), np.float32)
    ag_yaw = np.zeros((n_sc, n_ag, n_step, 1), np.float32)
    ag_yaw_rate = np.zeros((n_sc, n_ag, n_step, 1), np.float32)
    ag_type = np.zeros((n_sc, n_ag, 3), bool)
    ag_cmd = np.zeros((n_sc, n_ag, cfg.n_ag_cmd), bool)
    ag_role = np.zeros((n_sc, n_ag, 3), bool)
    ag_size = np.zeros((n_sc, n_ag, 3), np.float32)
    ag_goal = np.zeros((n_sc, n_ag, 4), np.float32)
    ag_dest = np.zeros((n_sc, n_ag), np.int64)
    n_ag_valid = max(2, int(n_ag * 0.7))
    for s in range(n_sc):
        ag_role[s, 0, 0] = True  # sdc
        for a in range(n_ag_valid):
            t0 = 0 if a < n_ag_valid // 2 else rng.integers(0, min(10, n_step - 2))
            t1 = n_step if rng.random() < 0.8 else rng.integers(t0 + 2, n_step + 1)
            ag_valid[s, a, t0:t1] = True
            typ = rng.integers(0, 3)
            ag_type[s, a, typ] = True
            ag_size[s, a] = [[4.5, 2.0, 1.6], [0.8, 0.8, 1.8], [1.8, 0.7, 1.7]][typ]
            pt = rng.uniform(-100, 100, 2)
            heading = rng.uniform(-np.pi, np.pi)
            spd = rng.uniform(0, [15, 2, 8][typ])
            for t in range(t0, t1):
                acc = rng.uniform(-1, 1)
                yr = rng.uniform(-0.2, 0.2)
                ag_pos[s, a, t, :2] = pt
                ag_yaw[s, a, t, 0] = heading
                ag_spd[s, a, t, 0] = spd
                ag_acc[s, a, t, 0] = acc
                ag_yaw_rate[s, a, t, 0] = yr
                ag_vel[s, a, t] = spd * np.array([np.cos(heading), np.sin(heading)])
                pt = pt + ag_vel[s, a, t] * dt
                heading += yr * dt
                spd = np.clip(spd + acc * dt, 0, 30)
            ag_cmd[s, a, rng.integers(0, cfg.n_ag_cmd)] = True
            if rng.random() < 0.3 and a > 0:
                ag_role[s, a, rng.integers(1, 3)] = True
            last = t1 - 1
            ag_goal[s, a] = [ag_pos[s, a, last, 0], ag_pos[s, a, last, 1], ag_yaw[s, a, last, 0], ag_spd[s, a, last, 0]]
            # dest must be an agent-type-compatible lane (navigation.py:263-273):
            # veh -> {0,1,2}, ped -> {4}, cyc -> {3,4}
            compat = [[0, 1, 2], [4], [3, 4]][typ]
            cand = [p for p in range(n_mp_valid) if mp_type[s, p, :].argmax() in compat]
            ag_dest[s, a] = rng.choice(cand) if cand else 0

    # --- traffic lights (lane-associated)
    tl_valid = np.zeros((n_sc, n_tl, n_step), bool)
    tl_state = np.zeros((n_sc, n_tl, n_step, cfg.n_tl_state), bool)
    tl_idx = np.full((n_sc, n_tl), -1, np.int64)
    n_tl_valid = max(1, n_tl // 3)
    for s in range(n_sc):
        for l in range(n_tl_valid):
            tl_valid[s, l] = True
            tl_idx[s, l] = rng.integers(0, n_mp_valid)
            state = rng.integers(1, cfg.n_tl_state)
            for t in range(n_step):
                if rng.random() < 0.02:
                    state = rng.integers(1, cfg.n_tl_state)
                tl_state[s, l, t, state] = True

    n_tls = cfg.n_tl_stop
    tl_stop_valid = tl_valid[:, :n_tls]
    tl_stop_state = tl_state[:, :n_tls]
    tl_stop_pos = np.zeros((n_sc, n_tls, 3), np.float32)
    tl_stop_dir = np.zeros((n_sc, n_tls, 3), np.float32)
    tl_stop_pos[..., :2] = rng.uniform(-100, 100, (n_sc, n_tls, 2))
    tl_stop_dir[..., 0] = 1.0

    boundary = np.zeros((n_sc, 4), np.float32)
    boundary[:, 0], boundary[:, 1] = -300, 300
    boundary[:, 2], boundary[:, 3] = -300, 300

    batch = {
        "agent/valid": ag_valid,
        "agent/pos": ag_pos,
        "agent/vel": ag_vel,
        "agent/spd": ag_spd,
        "agent/acc": ag_acc,
        "agent/yaw_bbox": ag_yaw,
        "agent/yaw_rate": ag_yaw_rate,
        "agent/type": ag_type,
        "agent/cmd": ag_cmd,
        "agent/role": ag_role,
        "agent/size": ag_size,
        "agent/goal": ag_goal,
        "agent/dest": ag_dest,
        "map/valid": mp_valid,
        "map/type": mp_type,
        "map/pos": mp_pos,
        "map/dir": mp_dir,
        "map/boundary": boundary,
        "tl_lane/valid": tl_valid,
        "tl_lane/state": tl_state,
        "tl_lane/idx": tl_idx,
        "tl_stop/valid": tl_stop_valid,
        "tl_stop/state": tl_stop_state,
        "tl_stop/pos": tl_stop_pos,
        "tl_stop/dir": tl_stop_dir,
    }
    if test_mode:
        nh = cfg.n_step_history
        hist = {}
        for k in list(batch.keys()):
            if k.startswith("agent/") or k.startswith("tl_"):
                v = batch.pop(k)
                if v.ndim >= 3 and v.shape[2] == n_step:
                    v = v[:, :, :nh]
                elif v.ndim >= 2 and k.startswith("agent/") and v.shape[-1] == n_step:
                    v = v[..., :nh]
                hist[f"history/{k}"] = v
        for k in ("history/agent/goal", "history/agent/dest", "history/agent/cmd"):
            hist.pop(k, None)
        hist["history/agent/valid"] = hist["history/agent/valid"][:, :, :nh]
        batch.update(hist)
        # submission metadata (test split carries these: pack_h5_womd.py attrs
        # + data_h5_womd.py:136-173 agent_no_sim arrays)
        sid = np.zeros((n_sc, 16), np.int32)
        for i in range(n_sc):
            for j, ch in enumerate(f"synthetic_{seed}_{i}"[:16]):
                sid[i, j] = ord(ch)
        batch["scenario_id"] = sid
        batch["scenario_center"] = rng.normal(size=(n_sc, 2)).astype(np.float32) * 100
        batch["scenario_yaw"] = rng.uniform(-np.pi, np.pi, size=(n_sc,)).astype(np.float32)
        batch["history/agent/object_id"] = np.arange(n_sc * cfg.n_ag).reshape(n_sc, cfg.n_ag) + 1
        n_ns = cfg.n_ag_no_sim
        batch["history/agent_no_sim/valid"] = np.ones((n_sc, n_ns, nh), bool)
        batch["history/agent_no_sim/pos"] = rng.normal(size=(n_sc, n_ns, nh, 3)).astype(np.float32) * 30
        batch["history/agent_no_sim/yaw_bbox"] = rng.uniform(
            -np.pi, np.pi, size=(n_sc, n_ns, nh, 1)).astype(np.float32)
        batch["history/agent_no_sim/object_id"] = (
            np.arange(n_sc * n_ns).reshape(n_sc, n_ns) + 10_000)
    return batch
