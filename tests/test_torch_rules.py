"""PyTorch port: the level-1 rule checks against the goldens and the JAX package.

`sim/wosac_collision.py` and `sim/rule_checker.py` at check_level=1 are held
  - against the goldens of the reference's own code
    (`tests/golden/sim/{wosac_collision,rule_checker}.npz`, the files
    `tests/test_sim_parity.py` holds the JAX package to), with the same
    tolerances: 1e-4 on box corners and signed distances, flags identical;
  - against the JAX functions on random scenes made from a numpy seed:
    signed distances to 1e-4 m (float32 over ~100 m coordinates), flags and
    passive counters identical at every step;
  - end to end: the default `joint_future_pred` call of each package (the
    JAX package's default is check_level=1) gives the same violation flags
    on `tiny_config()` with the same weights.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_golden_model import load_golden
from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, set_threads
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.sim import rule_checker as jrc
from trafficbotsv15_tpu.sim import wosac_collision as jwc
from trafficbotsv15_tpu.train import evaluation as jax_eval
from trafficbotsv15_tpu_torch.sim import rule_checker as prc
from trafficbotsv15_tpu_torch.sim import wosac_collision as pwc
from trafficbotsv15_tpu_torch.train import evaluation as port_eval

set_threads()
GEOM_ATOL = 1e-4
LEVEL1 = ("collided", "collided_wosac", "run_road_edge", "run_red_light", "passive")
RULE_INPUTS = ("mp_boundary", "mp_valid", "mp_type", "mp_pos", "mp_dir", "ag_type", "ag_size", "tl_valid", "tl_pose",
               "ag_goal", "ag_dest")


def _live_pairs(valid):
    n_ag = valid.shape[1]
    return valid[:, :, None] & valid[:, None, :] & ~np.eye(n_ag, dtype=bool)[None]


def test_wosac_collision_vs_golden():
    _, ins, outs, _ = load_golden("sim", "wosac_collision")
    pose, size, valid = (torch.from_numpy(ins[k]) for k in ("pose", "size", "valid"))
    np.testing.assert_allclose(pwc.get_ag_bbox(pose, size[..., :2]).numpy(), outs["bbox"], rtol=1e-5, atol=GEOM_ATOL)
    sd = pwc.pairwise_signed_distance_soa(pose, size, valid).numpy()
    live = _live_pairs(ins["valid"])  # the reference masks dead pairs after its subtraction, the SoA path before
    np.testing.assert_allclose(np.where(live, sd, 0.0), np.where(live, outs["signed_dist"], 0.0),
                               rtol=1e-4, atol=GEOM_ATOL)
    np.testing.assert_array_equal(pwc.check_collided_wosac(pose, size, valid).numpy(), outs["collided"])


def test_rule_checker_level1_vs_golden():
    """The reference's 30-step scripted scenario: every key bit-exact at every step."""
    _, ins, outs, meta = load_golden("sim", "rule_checker")
    statics, state = prc.init_rule_checker(**{k: torch.from_numpy(ins[k]) for k in RULE_INPUTS})
    mismatches = []
    for t in range(meta["T"]):
        state, viol = prc.check_rules(statics, state, *(torch.from_numpy(ins[k][t]) for k in
                                                         ("valid", "pose", "motion", "tl_state")), check_level=1)
        assert set(viol) == set(outs)
        mismatches += [(t, k) for k in outs if not np.array_equal(viol[k].numpy(), outs[k][t])]
    assert not mismatches, mismatches[:10]
    for k in LEVEL1:  # the scenario fires every level-1 check, so the match is not vacuous
        assert outs[k][-1].any(), k


def _random_scene(seed, n_sc=3, n_ag=12, n_mp=40, n_node=6, n_tl=9):
    """A scene with agents packed into a 40 m square among road edges, lanes and lights."""
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=-20.0, hi=20.0: rng.uniform(lo, hi, s).astype(np.float32)
    mp_type = np.zeros((n_sc, n_mp, 11), bool)
    mp_type[np.arange(n_sc)[:, None], np.arange(n_mp)[None], rng.integers(0, 8, (n_sc, n_mp))] = True
    ag_type = np.zeros((n_sc, n_ag, 3), bool)
    ag_type[np.arange(n_sc)[:, None], np.arange(n_ag)[None], rng.choice(3, (n_sc, n_ag), p=[0.7, 0.2, 0.1])] = True
    size = np.stack([f(n_sc, n_ag, lo=1.0, hi=6.0), f(n_sc, n_ag, lo=0.5, hi=2.5), f(n_sc, n_ag, lo=1, hi=2)], -1)
    statics = dict(
        mp_boundary=np.tile(np.array([[-18, 18, -18, 18]], np.float32), (n_sc, 1)),
        mp_valid=rng.uniform(size=(n_sc, n_mp, n_node)) < 0.8, mp_type=mp_type,
        mp_pos=f(n_sc, n_mp, n_node, 3), mp_dir=f(n_sc, n_mp, n_node, 3, lo=-3, hi=3),
        ag_type=ag_type, ag_size=size, tl_valid=rng.uniform(size=(n_sc, n_tl)) < 0.8,
        tl_pose=f(n_sc, n_tl, 3), ag_goal=f(n_sc, n_ag, 4), ag_dest=rng.integers(0, n_mp, (n_sc, n_ag)))
    steps = []
    pose = np.concatenate([f(n_sc, n_ag, 2), f(n_sc, n_ag, 1, lo=-np.pi, hi=np.pi)], -1)
    for _ in range(25):
        pose = pose + np.concatenate([f(n_sc, n_ag, 2, lo=-0.5, hi=0.5), f(n_sc, n_ag, 1, lo=-0.1, hi=0.1)], -1)
        motion = np.concatenate([f(n_sc, n_ag, 1, lo=0, hi=8), f(n_sc, n_ag, 2, lo=-1, hi=1)], -1)
        tl_state = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (n_sc, n_tl))]
        steps.append((rng.uniform(size=(n_sc, n_ag)) < 0.9, pose.astype(np.float32), motion, tl_state))
    return statics, steps


@pytest.mark.parametrize("seed", [0, 1])
def test_wosac_collision_vs_jax_random(seed):
    statics, steps = _random_scene(seed)
    for valid, pose, _, _ in steps[::5]:
        size = statics["ag_size"]
        sd = pwc.pairwise_signed_distance_soa(torch.from_numpy(pose), torch.from_numpy(size), torch.from_numpy(valid))
        jsd = np.asarray(jwc.pairwise_signed_distance_soa(jnp.asarray(pose), jnp.asarray(size), jnp.asarray(valid)))
        np.testing.assert_allclose(sd.numpy(), jsd, rtol=0, atol=GEOM_ATOL)
        got = pwc.check_collided_wosac(torch.from_numpy(pose), torch.from_numpy(size), torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwc.check_collided_wosac(
            jnp.asarray(pose), jnp.asarray(size), jnp.asarray(valid))))


@pytest.mark.parametrize("segment_budget", [6144, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_rule_checker_level1_vs_jax_random(seed, segment_budget):
    """Every key and the passive counter equal at every step; a budget below the
    scene's 240 node segments exercises the compaction of road edges and lanes."""
    statics, steps = _random_scene(seed)
    js, jst = jrc.init_rule_checker(**{k: jnp.asarray(v) for k, v in statics.items()}, segment_budget=segment_budget)
    ps, pst = prc.init_rule_checker(**{k: torch.from_numpy(v) for k, v in statics.items()},
                                    segment_budget=segment_budget)
    for name in ("road_edge", "road_edge_valid", "lane_center", "lane_center_valid", "collision_invalid_mask"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)
    fired = set()
    for t, step in enumerate(steps):
        jst, jv = jrc.check_rules(js, jst, *(jnp.asarray(x) for x in step), check_level=1)
        pst, pv = prc.check_rules(ps, pst, *(torch.from_numpy(x) for x in step), check_level=1)
        assert set(pv) == set(jv)
        for key in jv:
            np.testing.assert_array_equal(pv[key].numpy(), np.asarray(jv[key]), err_msg=f"step {t} {key}")
        np.testing.assert_array_equal(pst.passive_counter.numpy(), np.asarray(jst.passive_counter))
        fired |= {k for k in LEVEL1 if np.asarray(jv[k]).any()}
    assert fired >= {"collided", "collided_wosac", "run_road_edge"}, fired


def test_default_joint_future_pred_flags_match_jax():
    """Both packages' default call (no check_level given) on tiny_config: the
    K0 futures' violation flags are identical, level-1 checks included. The
    synthetic agents are made 6x their size and every second polyline a road
    edge, so that collisions and road-edge crossings happen; the port's old
    default, check_level=0, leaves those flags at zero where the JAX package
    raises them."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    batch["agent/size"] = batch["agent/size"] * 6
    batch["map/type"][:, 1::2] = np.eye(batch["map/type"].shape[-1], dtype=bool)[4]
    with jax_sort_knn():
        _, jbuf = jax_eval.joint_future_pred(cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
                                             {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                                             n_joint_future=2)
    jflags = {k: np.asarray(v)[:, 0] for k, v in jbuf.violation.items()}
    assert all(jflags[k].any() for k in ("collided", "collided_wosac", "run_road_edge"))
    pmodel = port_model(cfg, tree)

    def port_flags(**kw):
        _, pbuf = port_eval.joint_future_pred(port_cfg(cfg), pmodel, batch, n_joint_future=2, device="cpu",
                                              generator=torch.Generator().manual_seed(0), **kw)
        assert set(pbuf.violation) == set(jflags)
        return {k: v[:, 0].numpy() for k, v in pbuf.violation.items()}

    old = port_flags(check_level=0)
    assert not any(old[k].any() for k in LEVEL1)
    assert any(not np.array_equal(old[k], jflags[k]) for k in LEVEL1)
    new = port_flags()
    for key, val in jflags.items():
        np.testing.assert_array_equal(new[key], val, err_msg=key)
