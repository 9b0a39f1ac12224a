"""Traffic rule checker (counterpart of `trafficbotsv15_tpu/sim/rule_checker.py`).

A step function with accumulator state. check_level:
  0 = what feeds back into the rollout: leaving the map (agents are
      disabled) and reaching the goal / destination (the navigation target
      is invalidated);
  1 = the evaluation checks on top: box-overlap collision, WOSAC collision
      (`sim/wosac_collision.py`), running over a road edge, running a red
      light and being passive. The default of `joint_future_pred`.
At level 0 the level-1 keys carry their (all-False) accumulators, so the
buffer has the same keys at both levels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.ops.transform import cast_rad
from trafficbotsv15_tpu_torch.sim.wosac_collision import check_collided_wosac, get_ag_bbox, norm2

GOAL_THRESH_ROT = math.radians(15)
DEST_THRESH_ROT = math.radians(30)
COLLISION_SIZE_SCALE = 1.1  # agent boxes are enlarged by this factor for the collision checks


@dataclasses.dataclass
class RuleCheckerStatics:
    mp_boundary: torch.Tensor  # [n_sc, 4] (x_min, x_max, y_min, y_max)
    ag_size: torch.Tensor  # [n_sc, n_ag, 2] (length, width) scaled for the collision checks
    collision_invalid_mask: torch.Tensor  # [n_sc, n_ag, n_ag]: self and pedestrian-pedestrian pairs
    road_edge: torch.Tensor  # [n_sc, n_seg, 2, 2]
    road_edge_valid: torch.Tensor  # [n_sc, n_seg]
    lane_center: torch.Tensor  # [n_sc, n_seg, 2]
    lane_center_valid: torch.Tensor  # [n_sc, n_seg]
    veh_mask: torch.Tensor  # [n_sc, n_ag]
    rrl_agent_length: torch.Tensor  # [n_sc, n_ag, 1]
    rrl_agent_width: torch.Tensor  # [n_sc, n_ag, 1]
    tl_valid: torch.Tensor  # [n_sc, n_tl]
    tl_pose: torch.Tensor  # [n_sc, n_tl, 3]
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


def dest_statics_from_navi(ag_dest, mp_valid, mp_type, mp_pos, mp_dir) -> Dict[str, torch.Tensor]:
    """Per-agent statics of the destination polyline."""
    mp_pos, mp_dir = mp_pos[..., :2], mp_dir[..., :2]
    n_node = mp_valid.shape[2]
    idx = torch.clamp(ag_dest, 0, mp_valid.shape[1] - 1).long()
    dest_type = torch.gather(mp_type, 1, idx[..., None].expand(-1, -1, mp_type.shape[-1]))
    node_idx = idx[:, :, None, None].expand(-1, -1, n_node, 2)
    dest_dir = torch.gather(mp_dir, 1, node_idx)
    dest_dir = dest_dir / (norm2(dest_dir[..., 0], dest_dir[..., 1])[..., None] + 1e-12)
    thresh = torch.ones(ag_dest.shape[:2], device=ag_dest.device) * 50.0 * (1.0 - dest_type[:, :, 4] * 0.8)
    return dict(
        dest_invalid=~torch.gather(mp_valid, 1, idx[..., None].expand(-1, -1, n_node)),
        dest_type=dest_type,
        dest_pos=torch.gather(mp_pos, 1, node_idx),
        dest_dir=dest_dir,
        dest_thresh_pos=thresh,
    )


def _compact_segments(valid: torch.Tensor, budget: int, *arrays):
    """The first `budget` segments per scene in the order valid-first (stable):
    invalid segments never take part in a check, so keeping only the valid
    ones shrinks the per-step [n_ag, n_seg] tests when the budget covers them."""
    if budget >= valid.shape[1]:
        return (valid, *arrays)
    order = torch.argsort(~valid, dim=1, stable=True)[:, :budget]
    outs = [torch.gather(a, 1, order.reshape(*order.shape, *(1,) * (a.ndim - 2)).expand(*order.shape, *a.shape[2:]))
            for a in arrays]
    return (torch.gather(valid, 1, order), *outs)


def build_road_edges(mp_valid, mp_type, mp_pos, mp_dir, segment_budget: int = 6144):
    """Road-edge segments [n_sc, n_seg, 2, 2] and their validity [n_sc, n_seg]: each node of a polyline of
    type 4, 5 or 7 (road edge boundary / median) with its direction vector, valid ones first. The rule
    checker and the native WOSAC realism features share it."""
    n_sc, n_seg = mp_valid.shape[0], mp_valid.shape[1] * mp_valid.shape[2]
    pos, vec = mp_pos[..., :2], mp_dir[..., :2]
    road_edge_valid = (mp_valid & mp_type[:, :, [4, 5, 7]].any(-1, keepdim=True)).reshape(n_sc, n_seg)
    road_edge_valid, road_edge = _compact_segments(
        road_edge_valid, segment_budget, torch.stack([pos, pos + vec], -2).reshape(n_sc, n_seg, 2, 2))
    return road_edge, road_edge_valid


def init_rule_checker(mp_boundary, mp_valid, mp_type, mp_pos, mp_dir, ag_type, ag_size, tl_valid, tl_pose,
                      ag_goal=None, ag_dest=None, segment_budget: int = 6144) -> Tuple[RuleCheckerStatics, RuleCheckerState]:
    """Statics of one rollout + zeroed accumulators."""
    n_sc, n_ag = ag_type.shape[:2]
    dev = ag_type.device
    zeros = torch.zeros((n_sc, n_ag), dtype=torch.bool, device=dev)
    ped = ag_type[:, :, 1]
    collision_invalid = torch.eye(n_ag, dtype=torch.bool, device=dev)[None] | (ped[:, None, :] & ped[:, :, None])
    # lane centres: the nodes of polylines of types 0-2
    n_seg = mp_valid.shape[1] * mp_valid.shape[2]
    pos = mp_pos[..., :2]
    road_edge, road_edge_valid = build_road_edges(mp_valid, mp_type, mp_pos, mp_dir, segment_budget)
    lane_center_valid = (mp_valid & mp_type[:, :, :3].any(-1, keepdim=True)).reshape(n_sc, n_seg)
    lane_center_valid, lane_center = _compact_segments(lane_center_valid, segment_budget, pos.reshape(n_sc, n_seg, 2))
    dest = dict(dest_invalid=None, dest_type=None, dest_pos=None, dest_dir=None, dest_thresh_pos=None)
    if ag_dest is not None:
        dest = dest_statics_from_navi(ag_dest, mp_valid, mp_type, mp_pos, mp_dir)
    statics = RuleCheckerStatics(
        mp_boundary=mp_boundary, ag_size=ag_size[..., :2] * COLLISION_SIZE_SCALE,
        collision_invalid_mask=collision_invalid, road_edge=road_edge, road_edge_valid=road_edge_valid,
        lane_center=lane_center, lane_center_valid=lane_center_valid, veh_mask=ag_type[:, :, 0],
        rrl_agent_length=ag_size[:, :, 0:1] * 0.5 * 0.6, rrl_agent_width=ag_size[:, :, 1:2] * 0.5 * 1.8,
        tl_valid=tl_valid, tl_pose=tl_pose, ag_goal=ag_goal, goal_thresh_pos=ag_size[:, :, 0] * 8.0, **dest)
    state = RuleCheckerState(
        outside_map=zeros, collided=zeros, collided_wosac=zeros, run_road_edge=zeros, run_red_light=zeros,
        passive=zeros, passive_counter=torch.zeros((n_sc, n_ag), device=dev),
        goal_reached=zeros, dest_reached=zeros,
    )
    return statics, state


def _ccw(a, b, c):
    return (c[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0]) > (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])


def _check_collided(valid, bbox, collision_invalid_mask):
    """Box overlap by separating edges: a pair is apart when all four corners of
    one box lie outside one edge line of the other, in either order."""
    bbox_next = torch.roll(bbox, -1, 2)
    a = bbox_next[..., 1:2] - bbox[..., 1:2]
    b = bbox[..., 0:1] - bbox_next[..., 0:1]
    c = bbox_next[..., 0:1] * bbox[..., 1:2] - bbox_next[..., 1:2] * bbox[..., 0:1]
    line = torch.cat([a, b, c], -1)  # [n_sc, n_ag, 4, 3]
    point = torch.cat([bbox, torch.ones_like(bbox[..., 0:1])], -1)
    is_outside = torch.einsum("silc,sjpc->sijlp", line, point) > 0  # [n_sc, i, j, line of i, point of j]
    no_collision = is_outside.all(-1).any(-1)
    no_collision = no_collision | no_collision.transpose(1, 2)
    invalid = ~(valid[:, :, None] & valid[:, None, :])
    return ~(no_collision | collision_invalid_mask | invalid).all(-1)


def _check_run_road_edge(valid, bbox, veh_mask, road_edge, road_edge_valid):
    """A box edge crosses a valid road-edge segment. The [n_sc, n_ag, n_seg]
    tests are taken one box edge at a time, each with the JAX package's float
    operations, which bounds the intermediates at one [n_sc, n_ag, n_seg] set."""
    c = road_edge[:, None, :, 0, :]  # [n_sc, 1, n_seg, 2]
    d = road_edge[:, None, :, 1, :]
    corners = bbox[:, :, None]  # [n_sc, n_ag, 1, 4, 2]
    side = [_ccw(corners[..., i, :], c, d) for i in range(4)]  # corner i vs each segment's line
    hit = None
    for i in range(4):
        a, b = corners[..., i, :], corners[..., (i + 1) % 4, :]
        h = (side[i] != side[(i + 1) % 4]) & (_ccw(a, b, c) != _ccw(a, b, d))
        hit = h if hit is None else hit | h
    return (hit & road_edge_valid[:, None, :]).any(-1) & valid & veh_mask


def _check_run_red_light(valid, pose, motion, s: RuleCheckerStatics, tl_state):
    """A vehicle's front box leaves a red light's stop point this step."""
    c, si = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    hf = torch.stack([c, si], -1)[:, :, None]  # [n_sc, n_ag, 1, 2]
    hr = torch.stack([si, -c], -1)[:, :, None]
    xy0 = pose[..., :2][:, :, None]
    xy1 = xy0 + 0.1 * motion[..., 0:1][:, :, None] * hf
    tl_xy = s.tl_pose[:, None, :, :2]

    def inside(xy):
        rel = tl_xy - xy
        return ((torch.abs((rel * hf).sum(-1)) < s.rrl_agent_length)
                & (torch.abs((rel * hr).sum(-1)) < s.rrl_agent_width))

    m_ag = (valid & s.veh_mask)[:, :, None]
    m_tl = (s.tl_valid & tl_state[:, :, 1].bool())[:, None, :]
    return (inside(xy0) & ~inside(xy1) & m_ag & m_tl).any(-1)


def _check_passive(valid, pose, motion, tl_state, s: RuleCheckerStatics, passive_counter):
    """A vehicle slow near a lane with no red light and no agent ahead, for more than 20 steps."""
    rel = pose[:, :, None, :2] - s.lane_center[:, None]
    close_to_lane = ((norm2(rel[..., 0], rel[..., 1]) < 2.0) & s.lane_center_valid[:, None]).any(-1)
    low_speed = motion[..., 0] < 5.0
    hf = torch.stack([torch.cos(pose[..., 2]), torch.sin(pose[..., 2])], -1)[:, :, None]

    def close_ahead(vec):
        norm = norm2(vec[..., 0], vec[..., 1])
        return (norm < 10.0) & ((hf * vec).sum(-1) / (norm + 1e-12) > 0.95)

    m_tl = (s.tl_valid & tl_state[:, :, [0, 1, 2, 4]].bool().any(-1))[:, None]
    red_ahead = (close_ahead(s.tl_pose[:, None, :, :2] - pose[:, :, None, :2]) & m_tl).any(-1)
    n_ag = valid.shape[1]
    ego = torch.eye(n_ag, dtype=torch.bool, device=valid.device)[None]
    other_ahead = (close_ahead(pose[:, None, :, :2] - pose[:, :, None, :2])
                   & valid[:, None, :] & valid[:, :, None] & ~ego).any(-1)
    passive_now = valid & s.veh_mask & close_to_lane & low_speed & ~red_ahead & ~other_ahead
    counter = (passive_counter + passive_now) * passive_now
    return counter > 20, counter


def _check_goal_reached(valid, pose, goal, goal_reached, thresh_pos):
    rel = pose[..., :2] - goal[..., :2]
    pos_ok = norm2(rel[..., 0], rel[..., 1]) < thresh_pos
    rot_ok = torch.abs(cast_rad(pose[..., 2] - goal[..., 2])) < GOAL_THRESH_ROT
    return pos_ok & rot_ok & valid & ~goal_reached


def _check_dest_reached(valid, pose, s: RuleCheckerStatics, dest_reached):
    rel = pose[:, :, None, :2] - s.dest_pos
    dist = norm2(rel[..., 0], rel[..., 1])
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
    x, y = pose[..., 0], pose[..., 1]
    b = statics.mp_boundary
    outside_now = ((x > b[:, 1:2]) | (x < b[:, 0:1]) | (y > b[:, 3:4]) | (y < b[:, 2:3])) & valid
    if check_level >= 1:
        bbox = get_ag_bbox(pose, statics.ag_size)
        now = dict(
            collided=_check_collided(valid, bbox, statics.collision_invalid_mask),
            collided_wosac=check_collided_wosac(pose, statics.ag_size, valid),
            run_road_edge=_check_run_road_edge(valid, bbox, statics.veh_mask, statics.road_edge,
                                               statics.road_edge_valid),
            run_red_light=_check_run_red_light(valid, pose, motion, statics, tl_state),
        )
        now["passive"], counter = _check_passive(valid, pose, motion, tl_state, statics, state.passive_counter)
    else:
        level1 = ("collided", "collided_wosac", "run_road_edge", "run_red_light", "passive")
        now = {k: getattr(state, k) for k in level1}
        counter = state.passive_counter
    goal_now = torch.zeros_like(state.goal_reached)
    if statics.ag_goal is not None:
        goal_now = _check_goal_reached(valid, pose, statics.ag_goal, state.goal_reached, statics.goal_thresh_pos)
    dest_now = torch.zeros_like(state.dest_reached)
    if statics.dest_pos is not None:
        dest_now = _check_dest_reached(valid, pose, statics, state.dest_reached)
    now.update(outside_map=outside_now, goal_reached=goal_now, dest_reached=dest_now)
    new_state = RuleCheckerState(passive_counter=counter, **{k: getattr(state, k) | v for k, v in now.items()})
    violations = {}
    for k in ("outside_map", "collided", "collided_wosac", "run_road_edge", "run_red_light", "passive",
              "goal_reached", "dest_reached"):
        violations[k], violations[f"{k}_this_step"] = getattr(new_state, k), now[k]
    return new_state, violations
