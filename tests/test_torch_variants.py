"""PyTorch port: the input, TL and pose variants against the JAX package, on the CPU.

Module by module:
  - the pose embeddings `xy_dir` and `pe_xy_dir` (direction as yaw and as cos/sin) to 1e-6; `pe_xy_dir`'s angles
    are JAX's bit for bit (torch's cos and sin of JAX's angle tensor give the port's output exactly);
  - InputEncoder mode `input` (attr ++ pe into one MLP) with and without a pose embedding, 1e-5;
  - pre-processing in `tl_mode="stop"` (training and test split): every field equal to JAX's, bit for bit
    (exactly so where integer or bool), tl_attr None in both;
  - the level-1 rule checks with stop-line TL poses: agents driving out of a red stop line's box, every flag equal
    to JAX's at every step, and run_red_light fired;
  - the JAX model refuses `apply_q_rpe` (its TL encoder's static K/V hoist asserts against it); the port runs it.
The attention, blocks and model methods of these variants are `tests/test_torch_models.py`'s
(`test_attention_rpe_branches` q_rpe cases, `test_transformer_block_q_rpe`, `test_traffic_bots_variant_methods`).

Then `joint_future_pred` in each variant (`tests/torch_variant_common.py`: stop, stacked, input, pe_xy_dir, xy_dir
with use_pallas, and apply_q_rpe held against JAX without it through zero query rows): the K0 rows and every row
with JAX's draws injected at `tests/torch_rnn_common.py`'s tolerances, rule flags equal; the kernel wrappers'
calls: xy_dir's B4 and B2 at d_rpe = 4, none at all with apply_q_rpe and use_pallas. The training step is
`tests/test_torch_variants_train*.py`'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, port_cfg, random_tree, set_threads, t2n
from torch_navi_common import K
from torch_rnn_common import K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows, count_wrappers
from torch_variant_common import VARIANTS, prepare, run_joint_future, variant_cfg
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.ops import pose_emb as jpe
from trafficbotsv15_tpu_torch.ops import pose_emb as ppe

set_threads()


def _poses(seed=0, n=(40, 7)):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-200, 200, (*n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (*n, 1)).astype(np.float32)
    return xy, yaw, np.concatenate([np.cos(yaw), np.sin(yaw)], -1).astype(np.float32)


@pytest.mark.parametrize("direction", ["yaw", "cos_sin"])
@pytest.mark.parametrize("mode", ["xy_dir", "pe_xy_dir"])
def test_pose_embedding_matches_jax(mode, direction):
    xy, yaw, cs = _poses()
    d = yaw if direction == "yaw" else cs
    want = np.asarray(jpe.apply_pose_emb(jpe.PoseEmbConfig(mode=mode, pe_dim=64), jnp.asarray(xy), jnp.asarray(d)))
    got = ppe.apply_pose_emb(ppe.PoseEmbConfig(mode=mode, pe_dim=64), torch.from_numpy(xy), torch.from_numpy(d))
    assert tuple(got.shape) == (40, 7, ppe.pose_emb_out_dim(ppe.PoseEmbConfig(mode=mode, pe_dim=64)))
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-6)


def test_pe_xy_dir_angles_are_jaxs():
    """JAX's stacked form: ang = [x, y, cos, sin][..., :, None] * [f_xy, f_xy, f_cs, f_cs] (f = 1 / theta ** (2i /
    quarter)), then stack([cos, sin], -2) flattened. torch's cos and sin of JAX's float32 angles are the port's
    output bit for bit, so the port's angles are JAX's."""
    xy, _, cs = _poses(1)
    quarter, half = 16, 8
    exponents = jnp.arange(0, quarter, 2, dtype=jnp.float32)[:half] / quarter
    freqs = jnp.stack([1.0 / (1e3 ** exponents)] * 2 + [1.0 / (1e1 ** exponents)] * 2)
    ang = torch.from_numpy(np.array(jnp.concatenate([jnp.asarray(xy), jnp.asarray(cs)], -1)[..., :, None] * freqs))
    want = torch.stack([torch.cos(ang), torch.sin(ang)], -2).reshape(40, 7, 64)
    got = ppe.apply_pose_emb(ppe.PoseEmbConfig(mode="pe_xy_dir", pe_dim=64, theta_xy=1e3, theta_cs=1e1),
                             torch.from_numpy(xy), torch.from_numpy(cs))
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_pe", [True, False])
def test_input_encoder_input_mode_matches_jax(with_pe):
    from trafficbotsv15_tpu.models.mlp import InputEncoder as JaxInputEncoder
    from trafficbotsv15_tpu_torch.models.mlp import InputEncoder
    from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

    rng = np.random.default_rng(3)
    attr = rng.normal(size=(2, 9, 17)).astype(np.float32)
    pe = rng.normal(size=(2, 9, 24)).astype(np.float32) if with_pe else None
    jm = JaxInputEncoder(hidden_dim=32, pe_dim=24, n_layer=3, mode="input")
    jpe_in = None if pe is None else jnp.asarray(pe)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(attr), jpe_in))
    params = random_tree(shapes, seed=2)["params"]
    pm = InputEncoder(17, 32, 24 if with_pe else 0, 3, "input")
    pm.load_state_dict(params_from_jax(params), strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(attr), jpe_in))
    got = pm(torch.from_numpy(attr), None if pe is None else torch.from_numpy(pe))
    np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
def test_stop_preprocessing_matches_jax(test_mode):
    """tl_mode="stop": the tl_stop/* keys (under history/ in the test split), no tl_attr, tl_pose the stop's
    position and atan2 of its direction (the JAX package's form, docs/PARITY.md L2)."""
    from trafficbotsv15_tpu.config import tiny_config
    from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
    from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre

    cfg = tiny_config()
    batch = make_batch(cfg.data, n_sc=2, seed=5, test_mode=test_mode)
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    kw = dict(tl_mode="stop", navi_mode="dest", n_step_hist=cfg.n_step_hist, training=not test_mode)
    want = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    got = port_pre({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, **kw)
    assert got.tl_attr is None and want.tl_attr is None
    pose_key = "history/tl_stop/pos" if test_mode else "tl_stop/pos"
    assert got.tl_pose.shape[1] == batch[pose_key].shape[1]
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (g is None) == (w is None), f.name
        if g is not None:
            np.testing.assert_array_equal(t2n(g) if g.dtype == torch.bool else g.numpy(), np.asarray(w),
                                          err_msg=f.name)


def test_red_light_with_stop_poses_matches_jax():
    """The rule checker's red-light test reads the stop lines' poses: agents start in a box around a stop line
    whose light is red and drive out of it; every flag and the passive counter equal JAX's at every step."""
    from trafficbotsv15_tpu.config import tiny_config
    from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
    from trafficbotsv15_tpu.sim import rule_checker as jrc
    from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre
    from trafficbotsv15_tpu_torch.sim import rule_checker as prc

    cfg = tiny_config()
    batch = make_batch(cfg.data, n_sc=2, seed=6)
    kw = dict(tl_mode="stop", navi_mode="dest", n_step_hist=cfg.n_step_hist, training=True)
    jpp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    ppp = port_pre({k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    rng = np.random.default_rng(7)
    n_sc, n_ag = ppp.ag_valid.shape[:2]
    n_tl = ppp.tl_pose.shape[1]
    statics = dict(mp_boundary=batch["map/boundary"], mp_valid=batch["map/valid"], mp_type=batch["map/type"],
                   mp_pos=batch["map/pos"], mp_dir=batch["map/dir"], ag_type=np.asarray(jpp.ag_type),
                   ag_size=np.asarray(jpp.ag_size), tl_valid=np.asarray(jpp.tl_valid), ag_goal=batch["agent/goal"],
                   ag_dest=batch["agent/dest"])
    js, jst = jrc.init_rule_checker(**{k: jnp.asarray(v) for k, v in statics.items()}, tl_pose=jpp.tl_pose)
    ps, pst = prc.init_rule_checker(**{k: torch.from_numpy(np.asarray(v)) for k, v in statics.items()},
                                    tl_pose=ppp.tl_pose)
    stop_xy = t2n(ppp.tl_pose)[..., :2]
    on = rng.integers(0, n_tl, (n_sc, n_ag))  # each agent starts at a stop line, heading any way, at speed
    xy = np.take_along_axis(stop_xy, on[..., None], 1) + rng.uniform(-0.5, 0.5, (n_sc, n_ag, 2))
    pose = np.concatenate([xy, rng.uniform(-np.pi, np.pi, (n_sc, n_ag, 1))], -1).astype(np.float32)
    fired = False
    for _ in range(6):
        motion = np.concatenate([rng.uniform(5, 40, (n_sc, n_ag, 1)), rng.uniform(-1, 1, (n_sc, n_ag, 2))], -1)
        tl_state = np.zeros((n_sc, n_tl, 5), np.float32)
        tl_state[..., 1] = 1.0  # red
        step = (np.ones((n_sc, n_ag), bool), pose, motion.astype(np.float32), tl_state)
        jst, jv = jrc.check_rules(js, jst, *(jnp.asarray(x) for x in step), check_level=1)
        pst, pv = prc.check_rules(ps, pst, *(torch.from_numpy(x) for x in step), check_level=1)
        for key in jv:
            np.testing.assert_array_equal(pv[key].numpy(), np.asarray(jv[key]), err_msg=key)
        fired |= bool(np.asarray(jv["run_red_light_this_step"]).any())
        pose = pose + np.concatenate([0.1 * motion[..., :1] * np.cos(pose[..., 2:]),
                                      0.1 * motion[..., :1] * np.sin(pose[..., 2:]), 0 * pose[..., 2:]], -1)
        pose = pose.astype(np.float32)
    np.testing.assert_array_equal(pst.passive_counter.numpy(), np.asarray(jst.passive_counter))
    assert fired


def test_jax_model_refuses_apply_q_rpe():
    """The JAX package runs apply_q_rpe in its attention but not in its model: the TL encoder's hoist of the static
    K/V asserts against it. The port's model runs it, with no K/V hoisted (below)."""
    cfg = variant_cfg("q_rpe")
    with pytest.raises(AssertionError):
        jax_model_params(cfg)


@pytest.fixture(scope="module", params=VARIANTS)
def run(request):
    return run_joint_future(*prepare(request.param))


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_variant_joint_future_pred_k0_rows(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_variant_rollout_with_injected_samples_every_row(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_variant_rollout_rule_flags(run):
    assert_flags(run["jroll"], run["injected"])
    assert_flags(run["jbuf"], run["pbuf"], k0_only=True)


def test_xy_dir_reaches_the_kernel_wrappers_at_d_rpe_4(monkeypatch):
    """The 4-wide RPE goes to B4 (the map encoder once per layer, and at dense_knn_max 4 the agent decoder's
    self-attention once per layer and step) and B2 (the agent decoder's cross-attention once per layer and step),
    every call with rpe [b, s, K, 4]; on the card the general kernels take it (phase 3 holds them at d_rpe = 4)."""
    from trafficbotsv15_tpu_torch.ops import knarpe
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    widths = {"knarpe_attention": [], "knarpe_cross_attention": []}
    for name, at in (("knarpe_attention", 3), ("knarpe_cross_attention", 2)):  # where each wrapper takes rpe
        def counted(*a, _real=getattr(knarpe, name), _name=name, _at=at):
            widths[_name].append(a[_at].shape[-1])  # rpe [b, s, K, R]
            return _real(*a)
        monkeypatch.setattr(knarpe, name, counted)
    cfg = port_cfg(variant_cfg("xy_dir"))
    port_eval.joint_future_pred(cfg, build_model(cfg, seed=0, device="cpu"), make_batch(cfg.data, n_sc=1, seed=0),
                                generator=torch.Generator().manual_seed(0), n_joint_future=K, device="cpu")
    m, n = cfg.model, cfg.time_step_end
    assert len(widths["knarpe_attention"]) == m.mp_encoder.n_layer_tf + m.ag_encoder.n_layer_tf * n
    assert len(widths["knarpe_cross_attention"]) == m.ag_encoder.n_layer_tf * n
    assert set(widths["knarpe_attention"]) == set(widths["knarpe_cross_attention"]) == {4}


def test_q_rpe_reaches_no_kernel_wrapper(monkeypatch):
    """apply_q_rpe with use_pallas and dense_knn_max 4: every attention on the plain path, as JAX's gate says; the
    TL tokens carry no static K/V."""
    import dataclasses as dc

    base = variant_cfg("q_rpe")
    cfg = dc.replace(base, model=dc.replace(base.model, tf_cfg=dc.replace(base.model.tf_cfg, use_pallas=True,
                                                                           dense_knn_max=4)))
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, seed=0, device="cpu")
    calls = count_wrappers(monkeypatch)
    batch = port_eval.batch_to_device(make_batch(pcfg.data, n_sc=1, seed=0), torch.device("cpu"))
    scene = port_eval.prepare_joint_future(pcfg, model, batch)
    assert scene.tl_tokens.static_kv is None
    _, buf = port_eval.joint_future_pred(pcfg, model, batch, generator=torch.Generator().manual_seed(0),
                                         n_joint_future=K, device="cpu")
    assert torch.isfinite(buf.pred_pose).all()
    assert not calls["knarpe_attention"] and not calls["knarpe_cross_attention"]
