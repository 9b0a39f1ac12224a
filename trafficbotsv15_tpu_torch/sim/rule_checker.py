"""Traffic rule checker at check level 0 (counterpart of `trafficbotsv15_tpu/sim/rule_checker.py`).

Level 0 tracks what feeds back into the rollout: leaving the map (agents
are disabled) and reaching the goal / destination (the navigation target
is invalidated). Level 1 adds the collision, WOSAC-collision, road-edge,
red-light and passive checks, which come with the next slice and raise here.
The level-1 keys stay in the violation dict, carrying their (all-False)
accumulators, so the buffer has the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.ops.transform import cast_rad

GOAL_THRESH_ROT = math.radians(15)
DEST_THRESH_ROT = math.radians(30)


@dataclasses.dataclass
class RuleCheckerStatics:
    mp_boundary: torch.Tensor  # [n_sc, 4] (x_min, x_max, y_min, y_max)
    ag_goal: Optional[torch.Tensor]  # [n_sc, n_ag, 4] or None
    goal_thresh_pos: torch.Tensor  # [n_sc, n_ag]
    dest_invalid: Optional[torch.Tensor]  # [n_sc, n_ag, n_node]
    dest_type: Optional[torch.Tensor]  # [n_sc, n_ag, n_mp_type]
    dest_pos: Optional[torch.Tensor]  # [n_sc, n_ag, n_node, 2]
    dest_dir: Optional[torch.Tensor]  # [n_sc, n_ag, n_node, 2]
    dest_thresh_pos: Optional[torch.Tensor]  # [n_sc, n_ag]


@dataclasses.dataclass
class RuleCheckerState:
    outside_map: torch.Tensor  # [n_sc, n_ag] accumulated flags
    collided: torch.Tensor
    collided_wosac: torch.Tensor
    run_road_edge: torch.Tensor
    run_red_light: torch.Tensor
    passive: torch.Tensor
    passive_counter: torch.Tensor  # float32
    goal_reached: torch.Tensor
    dest_reached: torch.Tensor


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def dest_statics_from_navi(ag_dest, mp_valid, mp_type, mp_pos, mp_dir) -> Dict[str, torch.Tensor]:
    """Per-agent statics of the destination polyline."""
    mp_pos, mp_dir = mp_pos[..., :2], mp_dir[..., :2]
    n_node = mp_valid.shape[2]
    idx = torch.clamp(ag_dest, 0, mp_valid.shape[1] - 1).long()
    dest_type = torch.gather(mp_type, 1, idx[..., None].expand(-1, -1, mp_type.shape[-1]))
    node_idx = idx[:, :, None, None].expand(-1, -1, n_node, 2)
    dest_dir = torch.gather(mp_dir, 1, node_idx)
    dest_dir = dest_dir / (_norm2(dest_dir)[..., None] + 1e-12)
    thresh = torch.ones(ag_dest.shape[:2], device=ag_dest.device) * 50.0 * (1.0 - dest_type[:, :, 4] * 0.8)
    return dict(
        dest_invalid=~torch.gather(mp_valid, 1, idx[..., None].expand(-1, -1, n_node)),
        dest_type=dest_type,
        dest_pos=torch.gather(mp_pos, 1, node_idx),
        dest_dir=dest_dir,
        dest_thresh_pos=thresh,
    )


def init_rule_checker(mp_boundary, mp_valid, mp_type, mp_pos, mp_dir, ag_type, ag_size,
                      ag_goal=None, ag_dest=None) -> Tuple[RuleCheckerStatics, RuleCheckerState]:
    """Level-0 statics + zeroed accumulators."""
    n_sc, n_ag = ag_type.shape[:2]
    zeros = torch.zeros((n_sc, n_ag), dtype=torch.bool, device=ag_type.device)
    dest = dict(dest_invalid=None, dest_type=None, dest_pos=None, dest_dir=None, dest_thresh_pos=None)
    if ag_dest is not None:
        dest = dest_statics_from_navi(ag_dest, mp_valid, mp_type, mp_pos, mp_dir)
    statics = RuleCheckerStatics(mp_boundary=mp_boundary, ag_goal=ag_goal,
                                 goal_thresh_pos=ag_size[:, :, 0] * 8.0, **dest)
    state = RuleCheckerState(
        outside_map=zeros, collided=zeros, collided_wosac=zeros, run_road_edge=zeros, run_red_light=zeros,
        passive=zeros, passive_counter=torch.zeros((n_sc, n_ag), device=ag_type.device),
        goal_reached=zeros, dest_reached=zeros,
    )
    return statics, state


def _check_goal_reached(valid, pose, goal, goal_reached, thresh_pos):
    pos_ok = _norm2(pose[..., :2] - goal[..., :2]) < thresh_pos
    rot_ok = torch.abs(cast_rad(pose[..., 2] - goal[..., 2])) < GOAL_THRESH_ROT
    return pos_ok & rot_ok & valid & ~goal_reached


def _check_dest_reached(valid, pose, s: RuleCheckerStatics, dest_reached):
    dist = _norm2(pose[:, :, None, :2] - s.dest_pos)
    dist = torch.where(s.dest_invalid, float("inf"), dist)
    pos_ok = (dist < s.dest_thresh_pos[..., None]).any(-1)
    hf = torch.stack([torch.cos(pose[..., 2]), torch.sin(pose[..., 2])], -1)
    rot = torch.where(s.dest_invalid, 0.0, torch.sum(hf[:, :, None] * s.dest_dir, -1))
    rot_ok = (rot > math.cos(DEST_THRESH_ROT)).any(-1)
    m_lane = s.dest_type[:, :, :4].any(-1)
    m_edge = s.dest_type[:, :, 4]
    return ~dest_reached & valid & ((m_lane & pos_ok & rot_ok) | (m_edge & pos_ok))


def check_rules(statics: RuleCheckerStatics, state: RuleCheckerState, valid, pose, motion, tl_state,
                check_level: int) -> Tuple[RuleCheckerState, Dict[str, torch.Tensor]]:
    """One step of rule checking; returns (new_state, violations with *_this_step keys)."""
    if check_level >= 1:
        raise NotImplementedError("rule checks at level >= 1 (collisions, road edge, red light, passive) "
                                  "come with the next slice")
    x, y = pose[..., 0], pose[..., 1]
    b = statics.mp_boundary
    outside_now = ((x > b[:, 1:2]) | (x < b[:, 0:1]) | (y > b[:, 3:4]) | (y < b[:, 2:3])) & valid
    goal_now = torch.zeros_like(state.goal_reached)
    if statics.ag_goal is not None:
        goal_now = _check_goal_reached(valid, pose, statics.ag_goal, state.goal_reached, statics.goal_thresh_pos)
    dest_now = torch.zeros_like(state.dest_reached)
    if statics.dest_pos is not None:
        dest_now = _check_dest_reached(valid, pose, statics, state.dest_reached)
    new_state = dataclasses.replace(state, outside_map=state.outside_map | outside_now,
                                    goal_reached=state.goal_reached | goal_now,
                                    dest_reached=state.dest_reached | dest_now)
    level1 = ("collided", "collided_wosac", "run_road_edge", "run_red_light", "passive")
    violations = {
        "outside_map": new_state.outside_map, "outside_map_this_step": outside_now,
        **{f"{k}{sfx}": getattr(new_state, k) for k in level1 for sfx in ("", "_this_step")},
        "goal_reached": new_state.goal_reached, "goal_reached_this_step": goal_now,
        "dest_reached": new_state.dest_reached, "dest_reached_this_step": dest_now,
    }
    return new_state, violations
