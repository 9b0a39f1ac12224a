"""PyTorch port: ops, distributions, data prep and simulator pieces against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages on the
CPU in float32. Tolerances: 1e-5 absolute on O(1) outputs (reassociated
float32 sums), 1e-4 on metre-scale poses and on sinusoid embeddings of
metre-scale angles (the angle x*f carries x's 1e-5 relative rounding);
selections, masks and integer outputs must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_sort_knn, port_cfg, t2n
from trafficbotsv15_tpu import config as jcfg
from trafficbotsv15_tpu.data import preprocessing as jpre
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.ops import attention as jatt
from trafficbotsv15_tpu.ops import distributions as jdist
from trafficbotsv15_tpu.ops import pooling as jpool
from trafficbotsv15_tpu.ops import pose_emb as jpe
from trafficbotsv15_tpu.ops import rpe as jrpe
from trafficbotsv15_tpu.ops import transform as jtf
from trafficbotsv15_tpu.sim import dynamics as jdyn
from trafficbotsv15_tpu.sim import rule_checker as jrc
from trafficbotsv15_tpu.sim import teacher_forcing as jtfm
from trafficbotsv15_tpu_torch.data import preprocessing as ppre
from trafficbotsv15_tpu_torch.data.synthetic import make_batch as port_make_batch
from trafficbotsv15_tpu_torch.ops import attention as patt
from trafficbotsv15_tpu_torch.ops import distributions as pdist
from trafficbotsv15_tpu_torch.ops import pooling as ppool
from trafficbotsv15_tpu_torch.ops import pose_emb as ppe
from trafficbotsv15_tpu_torch.ops import rpe as prpe
from trafficbotsv15_tpu_torch.ops import transform as ptf
from trafficbotsv15_tpu_torch.sim import dynamics as pdyn
from trafficbotsv15_tpu_torch.sim import rule_checker as prc
from trafficbotsv15_tpu_torch.sim import teacher_forcing as ptfm

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def _f32(*shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def _pose(*shape, scale=100.0):
    return np.concatenate([_f32(*shape, 2, lo=-scale, hi=scale), _f32(*shape, 1, lo=-np.pi, hi=np.pi)], -1)


def _close(port, ref, atol):
    np.testing.assert_allclose(t2n(port), np.asarray(ref, dtype=np.float32), rtol=0, atol=atol)


T = torch.from_numpy
J = jnp.asarray


def test_transform():
    pos, origin, yaw = _f32(3, 5, 2, lo=-100, hi=100), _f32(3, 1, 2, lo=-100, hi=100), _f32(3, lo=-4, hi=4)
    _close(ptf.pos2local(T(pos), T(origin), ptf.rad2rot(T(yaw))), jtf.pos2local(J(pos), J(origin), jtf.rad2rot(J(yaw))),
           1e-4)
    ang = _f32(3, 5, lo=-10, hi=10)
    for cast in (True, False):
        _close(ptf.rad2local(T(ang), T(yaw), cast), jtf.rad2local(J(ang), J(yaw), cast), 1e-5)


@pytest.mark.parametrize("mode,pe_dim", [("pe_xy_yaw", 32), ("pe_xy_yaw", 128), ("mpa_pl", 7)])
def test_pose_emb(mode, pe_dim):
    xy, yaw = _f32(4, 6, 2, lo=-150, hi=150), _f32(4, 6, 1, lo=-np.pi, hi=np.pi)
    p = ppe.apply_pose_emb(ppe.PoseEmbConfig(mode=mode, pe_dim=pe_dim), T(xy), T(yaw))
    j = jpe.apply_pose_emb(jpe.PoseEmbConfig(mode=mode, pe_dim=pe_dim), J(xy), J(yaw))
    assert tuple(p.shape) == j.shape == (4, 6, ppe.pose_emb_out_dim(ppe.PoseEmbConfig(mode=mode, pe_dim=pe_dim)))
    _close(p, j, 1e-4)


@pytest.mark.parametrize("mode", ["max_valid", "last_valid"])
def test_seq_pooling(mode):
    x, inv = _f32(2, 5, 7, 8), RNG.uniform(size=(2, 5, 7)) < 0.4
    inv[0, 0] = True  # an all-invalid row is zeroed
    _close(ppool.seq_pooling(T(x), T(inv), mode), jpool.seq_pooling(J(x), J(inv), mode), 0)


def test_rel_pose_and_knn():
    pose, pose2 = _pose(2, 6), _pose(2, 40)
    inv, inv2 = RNG.uniform(size=(2, 6)) < 0.2, RNG.uniform(size=(2, 40)) < 0.2
    p_rel, p_dist = prpe.get_rel_pose(T(pose), T(inv), T(pose2), T(inv2))
    j_rel, j_dist = jrpe.get_rel_pose(J(pose), J(inv), J(pose2), J(inv2))
    _close(p_rel, j_rel, 1e-4)
    _close(p_dist, j_dist, 1e-4)
    with jax_sort_knn():
        j_idx, j_kinv, j_rpe = jrpe.get_tgt_knn(J(inv2), j_rel, j_dist, 9, 120.0)
    p_idx, p_kinv, p_rpe = prpe.get_tgt_knn(p_rel, p_dist, 9, 120.0)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_kinv.numpy(), np.asarray(j_kinv))
    _close(p_rpe, j_rpe, 1e-4)
    feat = _f32(2, 40, 16)
    _close(prpe.gather_tgt(T(feat), p_idx), jrpe.gather_tgt(J(feat), j_idx), 0)


def test_masked_softmax_all_invalid_row():
    logits, inv = _f32(2, 3, 5), RNG.uniform(size=(2, 3, 5)) < 0.5
    inv[1, 2] = True
    pa, pn = patt._masked_softmax(T(logits), T(inv))
    ja, jn = jatt._masked_softmax(J(logits), J(inv))
    _close(pa, ja, 1e-6)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert pn[1, 2] and torch.all(pa[1, 2] == 0)


def test_attention_kernels_math():
    b, s, t, k, h, d = 2, 5, 7, 4, 2, 8
    q, kd, vd = _f32(b, s, h, d), _f32(b, t, h, d), _f32(b, t, h, d)
    inv = RNG.uniform(size=(b, s, t)) < 0.3
    inv[0, 1] = True
    _close(patt.dense_attention(T(q), T(kd), T(vd), T(inv)), jatt.dense_attention(J(q), J(kd), J(vd), J(inv))[0], 1e-5)
    kk, vv, rk, rv = (_f32(b, s, k, h, d) for _ in range(4))
    kinv = RNG.uniform(size=(b, s, k)) < 0.3
    kinv[1, 0] = True
    _close(patt.knn_attention(T(q), T(kk), T(vv), T(kinv), T(rk), T(rv)),
           jatt.knn_attention(J(q), J(kk), J(vv), J(kinv), rpe_k=J(rk), rpe_v=J(rv))[0], 1e-5)
    qf, kf, vf = _f32(b, s, h * d), _f32(b, s, k, h * d), _f32(b, s, k, h * d)
    _close(patt.knn_attention_fullwidth(T(qf), T(kf), T(vf), T(kinv), h),
           jatt.knn_attention_fullwidth(J(qf), J(kf), J(vf), J(kinv), h), 1e-5)


def test_distributions():
    mean, std, x = _f32(3, 4, 2), np.exp(_f32(3, 4, 2)), _f32(3, 4, 2)
    _close(pdist.DiagGaussian(T(mean), T(std)).log_prob(T(x)), jdist.DiagGaussian(J(mean), J(std)).log_prob(J(x)), 1e-5)
    logits = _f32(3, 4, 9, lo=-3, hi=3)
    logits[0, 0, 2] = -1e9
    sample = RNG.integers(0, 9, (3, 4)).astype(np.int32)
    pd, jd = pdist.DestCategorical(T(logits)), jdist.DestCategorical(J(logits))
    _close(pd.log_prob(T(sample)), jd.log_prob(J(sample)), 1e-5)
    g = torch.Generator().manual_seed(0)
    mode = torch.from_numpy(np.asarray(jnp.argmax(J(logits), -1)).astype(np.int32))
    assert torch.equal(pd.sample(g, True), mode)
    # mixed deterministic: masked rows take the mode, the others a draw
    det = torch.zeros(3, 4, dtype=torch.bool)
    det[::2] = True
    s = pd.sample(g, det)
    assert torch.equal(s[det], mode[det])
    assert s.dtype == torch.int32 and bool(((s >= 0) & (s < 9)).all())
    gs = pdist.DiagGaussian(T(mean), T(std)).repeat(2, 0)  # [6, 4, 2], each scenario twice
    assert torch.equal(gs.mean[0], gs.mean[1])
    zdet = torch.zeros(6, 4, dtype=torch.bool)
    zdet[::2] = True
    z = gs.sample(g, zdet)
    assert torch.equal(z[::2], gs.mean[::2]) and not torch.equal(z[1::2], gs.mean[1::2])


def test_dynamics_and_tl_override():
    cfg = jcfg.DynamicsCfg()
    pose, motion, act = _pose(2, 6), _f32(2, 6, 3, lo=0, hi=10), _f32(2, 6, 2, lo=-3, hi=3)
    valid = RNG.uniform(size=(2, 6)) < 0.7
    typ = np.eye(3, dtype=bool)[RNG.integers(0, 3, (2, 6))]
    p = pdyn.step_dynamics(T(pose), T(motion), T(valid), T(act), T(typ), port_cfg(jcfg.ExperimentCfg()).dynamics)
    j = jdyn.step_dynamics(J(pose), J(motion), J(valid), J(act), J(typ), cfg)
    for a, b in zip(p, j):
        _close(a, b, 1e-4)
    logits, ov, gt = _f32(2, 5, 5), RNG.uniform(size=(2, 5)) < 0.5, np.eye(5, dtype=bool)[RNG.integers(0, 5, (2, 5))]
    np.testing.assert_array_equal(pdyn.override_tl(T(logits), T(ov), T(gt)).numpy(),
                                  np.asarray(jdyn.override_tl(J(logits), J(ov), J(gt))))


def _batch(cfg, seed=0):
    jb = make_batch(cfg.data, n_sc=2, seed=seed)
    pb = port_make_batch(port_cfg(cfg).data, n_sc=2, seed=seed)
    for key in jb:  # the port's copy of the generator gives the same batch
        np.testing.assert_array_equal(pb[key], jb[key])
    return jb


def test_preprocessing_and_forcing_and_rules():
    cfg = jcfg.tiny_config()
    nb = _batch(cfg, seed=2)
    jp = jpre.pre_processing({k: J(v) for k, v in nb.items()}, n_step_hist=cfg.n_step_hist)
    pp = ppre.pre_processing({k: T(v) for k, v in nb.items()}, n_step_hist=cfg.n_step_hist)
    for f in ("mp_valid", "mp_attr", "mp_pose", "tl_valid", "tl_state", "tl_pose", "ag_valid", "ag_attr",
              "ag_motion", "ag_pose", "gt_valid", "gt_pose", "gt_navi", "gt_tl_state", "ag_type", "ag_size"):
        _close(getattr(pp, f), getattr(jp, f), 1e-6)

    tf_cfg = cfg.teacher_forcing_joint_future_pred
    tl_force = np.ones(np.asarray(jp.tl_state).shape[:3], bool)
    j_force, _ = jtfm.build_forcing_masks(tf_cfg, jp.ag_valid, J(tl_force), 0, jax.random.PRNGKey(0))
    p_force, _ = ptfm.build_forcing_masks(port_cfg(cfg).teacher_forcing_joint_future_pred, pp.ag_valid, T(tl_force))
    np.testing.assert_array_equal(p_force.numpy(), np.asarray(j_force))

    dest = RNG.integers(0, cfg.data.n_mp, (2, cfg.data.n_ag))
    kw = dict(mp_boundary="map/boundary", mp_valid="map/valid", mp_pos="map/pos", mp_dir="map/dir")
    js, jst = jrc.init_rule_checker(**{k: J(nb[v]) for k, v in kw.items()}, mp_type=J(nb["map/type"]).astype(bool),
                                    ag_type=jp.ag_type, ag_size=jp.ag_size, tl_valid=jp.tl_valid, tl_pose=jp.tl_pose,
                                    ag_goal=J(nb["agent/goal"]), ag_dest=J(dest))
    ps, pst = prc.init_rule_checker(**{k: T(nb[v]) for k, v in kw.items()}, mp_type=T(nb["map/type"]),
                                    ag_type=pp.ag_type, ag_size=pp.ag_size, tl_valid=pp.tl_valid, tl_pose=pp.tl_pose,
                                    ag_goal=T(nb["agent/goal"]), ag_dest=T(dest))
    # poses near the goals and destinations, so the reached checks fire; levels 0 and 1 in turn
    goal = nb["agent/goal"]
    for step in range(4):
        pose = np.concatenate([goal[..., :2] + _f32(2, cfg.data.n_ag, 2, lo=-30, hi=30) * step,
                               goal[..., 2:3] + _f32(2, cfg.data.n_ag, 1, lo=-0.5, hi=0.5)], -1).astype(np.float32)
        valid = RNG.uniform(size=(2, cfg.data.n_ag)) < 0.8
        motion = _f32(2, cfg.data.n_ag, 3)
        tl = np.zeros((2, cfg.data.n_tl_lane, 5), np.float32)
        jst, jv = jrc.check_rules(js, jst, J(valid), J(pose), J(motion), J(tl), step % 2)
        pst, pv = prc.check_rules(ps, pst, T(valid), T(pose), T(motion), T(tl), step % 2)
        assert set(pv) == set(jv)
        for key in jv:
            np.testing.assert_array_equal(pv[key].numpy(), np.asarray(jv[key]), err_msg=key)
    assert np.asarray(jst.goal_reached).any()
    np.testing.assert_array_equal(pst.passive_counter.numpy(), np.asarray(jst.passive_counter))
