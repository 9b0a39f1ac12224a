"""PyTorch port: the native WOSAC realism (`eval/wosac_likelihood.py`) against the JAX package on the CPU.

Every function of the module takes the same inputs, made from a numpy seed,
in both packages: the kinematic, distance, time-to-collision and road-edge
features, the histogram and Bernoulli likelihoods, the bucket aggregation,
`compute_scenario_likelihoods`, and `realism_from_rollout` on a joint-future
buffer of the JAX package carried across. The port's copy of the challenge
tables equals the JAX package's, and the chunked features equal one chunk.

Tolerance: 1e-5 relative on float outputs, 1e-6 absolute near zero; bin
indices and counts exact. Signed distances: 1e-4 m, as `test_torch_rules.py`
holds the pair geometry (the port picks corners by gather where the JAX
package uses one-hot products). A likelihood is the exp of a mean over bins,
so one sample moved across a bin edge would move it by far more than 1e-5:
the 1e-5 on the likelihoods also shows that no sample changed bin. The JAX
functions run eagerly where a bin edge is at stake: under jit XLA rewrites
the divisions by dt, and some accelerations then land in the next bin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, set_threads, to_jnp
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import wosac_likelihood as jwl
from trafficbotsv15_tpu.train import evaluation as jax_eval
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
from trafficbotsv15_tpu_torch.eval import wosac_likelihood as pwl
from trafficbotsv15_tpu_torch.sim.rollout import RolloutBuffer
from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device

set_threads()
RTOL, ATOL, GEOM_ATOL = 1e-5, 1e-6, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _scene(seed, k=4, n_ag=6, n_step=12, n_seg=40):
    """One scenario: K noisy futures around a logged track of agents driving side by side, road edges."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_step, dtype=np.float32)
    logged = np.zeros((n_ag, n_step, 3), np.float32)
    for a in range(n_ag):
        logged[a, :, 0] = (3.0 + 0.3 * a) * t * 0.5 + 6.0 * (a % 3)
        logged[a, :, 1] = 2.5 * (a // 3) + 0.05 * t * a
        logged[a, :, 2] = 0.02 * t * (a - 2)
    sim = (logged[None] + rng.normal(size=(k, n_ag, n_step, 3)) * [0.3, 0.3, 0.05]).astype(np.float32)
    size = np.tile(np.array([[4.5, 2.0, 1.6]], np.float32), (n_ag, 1))
    size[1] = [0.8, 0.8, 1.8]
    edge_a = (rng.uniform(-10, 40, size=(n_seg, 2))).astype(np.float32)
    edge = np.stack([edge_a, edge_a + rng.normal(size=(n_seg, 2)).astype(np.float32) * 3], 1)
    return dict(sim=sim, sim_valid=np.arange(n_ag) != 4, logged=logged,
                logged_valid=rng.uniform(size=(n_ag, n_step)) < 0.9, size=size, edge=edge,
                edge_valid=rng.uniform(size=n_seg) < 0.8, sim_offroad=rng.uniform(size=(k, n_ag)) < 0.2,
                logged_offroad=rng.uniform(size=n_ag) < 0.2)


def test_challenge_tables_equal_jax():
    assert pwl.CHALLENGE_2024_CONFIG.keys() == jwl.CHALLENGE_2024_CONFIG.keys()
    for name, cfg in jwl.CHALLENGE_2024_CONFIG.items():
        ours = dict(pwl.CHALLENGE_2024_CONFIG[name])
        if "histogram" in cfg:
            assert dataclasses.asdict(ours.pop("histogram")) == dataclasses.asdict(cfg["histogram"]), name
        assert ours == {k: v for k, v in cfg.items() if k != "histogram"}, name
    assert {k: dataclasses.asdict(v) for k, v in pwl.FEATURE_CONFIG.items()} == \
        {k: dataclasses.asdict(v) for k, v in jwl.FEATURE_CONFIG.items()}
    assert pwl.FIELD_WEIGHTS == jwl.FIELD_WEIGHTS and pwl.BUCKETS == jwl.BUCKETS


def test_kinematic_features_match_jax():
    s = _scene(0)
    for got, want in zip(pwl.kinematic_features(_t(s["sim"])), jwl.kinematic_features(jnp.asarray(s["sim"]))):
        _close(got, want, atol=1e-4)  # differences over dt = 0.1 s of ~10 m coordinates: float32 ulps x 100


def test_pair_features_match_jax():
    s = _scene(1)
    pose, size = s["sim"][:, :, 3], np.broadcast_to(s["size"], (4,) + s["size"].shape)
    valid = np.broadcast_to(s["sim_valid"], (4, 6))
    _close(pwl.pairwise_signed_distance(_t(pose), _t(size[..., :2]), _t(valid)),
           jax.jit(jwl.pairwise_signed_distance)(jnp.asarray(pose), jnp.asarray(size[..., :2]), jnp.asarray(valid)),
           atol=GEOM_ATOL)
    spd = np.random.default_rng(2).uniform(0, 10, size=(4, 6)).astype(np.float32)
    got = pwl.time_to_collision(_t(pose), _t(spd), _t(size), _t(valid))
    want = jwl.time_to_collision(jnp.asarray(pose), jnp.asarray(spd), jnp.asarray(size), jnp.asarray(valid))
    _close(got, want)
    assert bool((got < 5.0).any())  # some agent has a leader it closes in on
    edge = np.broadcast_to(s["edge"], (4,) + s["edge"].shape)
    edge_valid = np.broadcast_to(s["edge_valid"], (4, 40))
    _close(pwl.distance_to_road_edge(_t(pose), _t(edge), _t(edge_valid)),
           jwl.distance_to_road_edge(jnp.asarray(pose), jnp.asarray(edge), jnp.asarray(edge_valid)), atol=1e-5)


@pytest.mark.parametrize("name", list(jwl.FEATURE_CONFIG))
def test_histogram_log_likelihood_matches_jax(name):
    cfg = jwl.FEATURE_CONFIG[name]
    rng = np.random.default_rng(3)
    span = cfg.val_max - cfg.val_min
    sim = (cfg.val_min + rng.uniform(-0.1, 1.1, size=(5, 4, 9)) * span).astype(np.float32)  # some outside the range
    logged = (cfg.val_min + rng.uniform(-0.1, 1.1, size=(4, 9)) * span).astype(np.float32)
    sim_valid, logged_valid = rng.uniform(size=sim.shape) < 0.9, rng.uniform(size=logged.shape) < 0.8
    want_sum, want_cnt = jwl.histogram_log_likelihood(jnp.asarray(sim), jnp.asarray(logged), jnp.asarray(sim_valid),
                                                      jnp.asarray(logged_valid), cfg)
    got_sum, got_cnt = pwl.histogram_log_likelihood(_t(sim), _t(logged), _t(sim_valid), _t(logged_valid),
                                                    pwl.FEATURE_CONFIG[name])
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    _close(got_sum, want_sum)
    scale = cfg.num_bins / span  # the JAX package's bins: int32 truncation, then the clip
    want_bins = np.clip(((jnp.asarray(sim) - cfg.val_min) * scale).astype(jnp.int32), 0, cfg.num_bins - 1)
    np.testing.assert_array_equal(pwl._bins(_t(sim), pwl.FEATURE_CONFIG[name]).numpy(), np.asarray(want_bins))


def test_bernoulli_and_aggregation_match_jax():
    rng = np.random.default_rng(4)
    sim_flag, logged_flag = rng.uniform(size=(32, 7)) < 0.3, rng.uniform(size=7) < 0.3
    sim_flag[:, 0] = False
    sim_flag[:, 1] = True
    _close(pwl.bernoulli_log_likelihood(_t(sim_flag), _t(logged_flag)),
           jwl.bernoulli_log_likelihood(jnp.asarray(sim_flag), jnp.asarray(logged_flag)))
    fields = {f: rng.uniform(0.1, 1.0) for f in jwl.FIELD_WEIGHTS}
    for drop in ((), ("distance_to_road_edge_likelihood", "offroad_indication_likelihood")):
        part = {k: v for k, v in fields.items() if k not in drop}
        got = pwl.aggregate_metametric({k: torch.tensor(v) for k, v in part.items()})
        want = jwl.aggregate_metametric({k: jnp.asarray(v, jnp.float32) for k, v in part.items()})
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], msg=key)


@pytest.mark.parametrize("with_map", [True, False])
def test_compute_scenario_likelihoods_match_jax(with_map):
    s = _scene(5)
    extra = dict(road_edge=s["edge"], road_edge_valid=s["edge_valid"], sim_offroad=s["sim_offroad"],
                 logged_offroad=s["logged_offroad"]) if with_map else {}
    args = (s["sim"], s["sim_valid"], s["logged"], s["logged_valid"], s["size"])
    # eager: under jit XLA rewrites the divisions by dt, which moves some accelerations to the next bin
    want = jwl.compute_scenario_likelihoods(*(jnp.asarray(a) for a in args),
                                            **{k: jnp.asarray(v) for k, v in extra.items()})
    got = pwl.compute_scenario_likelihoods(*(_t(a) for a in args), **{k: _t(v) for k, v in extra.items()})
    assert set(got) == set(want) and len(got) == (13 if with_map else 10)
    for key in want:
        _close(got[key], want[key], msg=key)


def _port_buffer(jbuf) -> RolloutBuffer:
    fields = {f.name: getattr(jbuf, f.name) for f in dataclasses.fields(RolloutBuffer)}
    conv = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else (None if v is None else _t(v)))
            for k, v in fields.items()}
    return RolloutBuffer(**conv)


@pytest.fixture(scope="module")
def jax_joint_futures():
    """A JAX joint-future buffer (tiny_config, K=6, check_level=1) with its batch and pre-processed batch."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    with jax_sort_knn():  # jitted: one compile instead of one per eager op
        jpp, jbuf = jax.jit(lambda p, b, key: jax_eval.joint_future_pred(cfg, jmodel, p, b, key, n_joint_future=6))(
            to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tbatch = batch_to_device(batch, torch.device("cpu"))
    pcfg = port_cfg(cfg)
    ppp = pre_processing(tbatch, tl_mode=pcfg.model.tl_mode, navi_mode=pcfg.model.navi_mode,
                         n_step_hist=pcfg.n_step_hist, training=True)
    return dict(cfg=cfg, batch=batch, tbatch=tbatch, jpp=jpp, jbuf=jbuf, ppp=ppp, pbuf=_port_buffer(jbuf))


def test_realism_from_rollout_matches_jax(jax_joint_futures):
    r = jax_joint_futures
    step_current = r["cfg"].time_step_current
    want = jax.jit(lambda b, pp, buf: jwl.realism_from_rollout(b, pp, buf, step_current))(
        {k: jnp.asarray(v) for k, v in r["batch"].items()}, r["jpp"], r["jbuf"])
    got = pwl.realism_from_rollout(r["tbatch"], r["ppp"], r["pbuf"], step_current)
    assert set(got) == set(want) and len(got) == 15
    for key in want:
        assert tuple(got[key].shape) == (2,), key
        _close(got[key], want[key], msg=key)
    assert all(0 < float(v) <= 1 for k, v in got.items() if k.endswith("_likelihood") for v in v)


def test_realism_chunked_equals_one_chunk(jax_joint_futures, monkeypatch):
    """The per-step features in chunks of a few pose sets give the same bits as in one chunk. The sizes keep
    every chunk a multiple of 64 values: the CPU's vector kernels take a tensor's tail with scalar code,
    whose sin / cos may round otherwise."""
    r = jax_joint_futures
    step_current = r["cfg"].time_step_current
    whole = pwl.realism_from_rollout(r["tbatch"], r["ppp"], r["pbuf"], step_current)
    calls = []
    real_cat = torch.cat

    def counting_cat(tensors, *a, **kw):
        calls.append(len(tensors))
        return real_cat(tensors, *a, **kw)

    n_ag, n_seg = r["cfg"].data.n_ag, r["tbatch"]["map/valid"][0].numel()
    monkeypatch.setattr(pwl, "CHUNK_ELEMS", 8 * n_ag * n_seg)  # 8 pose sets per road-edge chunk
    monkeypatch.setattr(pwl.torch, "cat", counting_cat)
    chunked = pwl.realism_from_rollout(r["tbatch"], r["ppp"], r["pbuf"], step_current)
    assert max(calls) >= 6  # the 60 pose sets of a scenario's futures went in 8 chunks
    for key in whole:
        assert torch.equal(chunked[key], whole[key]), key
