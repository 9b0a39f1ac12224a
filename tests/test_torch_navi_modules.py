"""PyTorch port: the navigation modules of the goal, cmd and dummy modes and AddNaviLatent's add and mul modes against
the JAX package's, module by module (tiny_config, gain-0.5 random weights carried by `utils/jax_import.py`).

  - `NaviEncoder` (goal, cmd, dummy) on the batch's `agent/goal` / `agent/cmd` and poses, over the JAX map tokens;
  - `NaviPredictor` (goal, cmd) on the pre-processed history and the JAX map tokens, on both track encoders: HPTR's
    temporal tokens (temp_window_size 11) and the GRU (temp_window_size 0); goal's mean and std, cmd's logits;
  - one policy `step` of each package from its own scene encoding with the navi fused by AddNaviLatent `add` or
    `mul` (goal navi): the action's mean and std.
Each with use_pallas False and True (dense_knn_max 4: the predictor's tf_ag2mp and the agent decoder through B2's
wrapper, the map encoder through B4's; on the CPU both packages take their plain versions). Tolerance: 1e-4
absolute + 1e-4 relative on every float32 output (float32 on both sides, summation order only); dummy's None and
validity masks exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_model, t2n, to_jnp
from torch_navi_common import navi_cfg
from trafficbotsv15_tpu.data.preprocessing import pre_processing
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.models.tokens import MapTokens as JaxMapTokens
from trafficbotsv15_tpu_torch.models.tokens import MapTokens

torch.set_num_threads(2)
ATOL = RTOL = 1e-4
PALLAS = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])


@functools.lru_cache(maxsize=None)
def _setup_for(mode: str, use_pallas: bool, track: str = "hptr", add_mode: str = "cat"):
    """`_setup` of the navi_cfg, shared by the tests of one configuration."""
    cfg = navi_cfg(mode, use_pallas=use_pallas, add_mode=add_mode)
    if track == "rnn":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temp_window_size=0))
    return (cfg, *_setup(cfg))


def _setup(cfg):
    """(JAX model, params, port model, JAX pre-processed batch, JAX map tokens, the same tokens for the port)."""
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    params = to_jnp(tree)
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg.data, n_sc=2, seed=1).items()}
    pp = pre_processing(batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training=True)
    with jax_sort_knn():
        mp = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, method="encode_map"))(
            params, pp.mp_valid, pp.mp_attr, pp.mp_pose, pp.mp_type)
    ptokens = MapTokens(**{f: torch.from_numpy(np.array(getattr(mp, f))) for f in ("invalid", "feature", "pose",
                                                                                    "type")})
    return jmodel, params, port_model(cfg, tree), pp, batch, mp, ptokens


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, name):
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL, err_msg=name)


@PALLAS
@pytest.mark.parametrize("mode", ["goal", "cmd", "dummy"])
def test_navi_encoder_matches_jax(mode, use_pallas):
    """The navi feature of the batch's goal / command, relative to each agent's last pose; None in dummy mode."""
    cfg, jmodel, params, pmodel, pp, batch, mp, ptokens = _setup_for(mode, use_pallas)
    navi = batch.get(f"agent/{mode}")
    pose = pp.ag_pose[:, :, -1]
    want = jmodel.apply({"params": params}, navi, pose, mp, method=lambda m, *a: m.navi_encoder(*a))
    with torch.no_grad():
        got = pmodel.navi_encoder(None if navi is None else _t(navi), _t(pose), ptokens)
    if mode == "dummy":
        assert want is None and got is None and not any(n.startswith("navi_") for n, _ in pmodel.named_parameters())
        return
    assert tuple(got.shape) == (2, cfg.data.n_ag, cfg.model.hidden_dim)
    _close(got, want, mode)


@PALLAS
@pytest.mark.parametrize("track", ["hptr", "rnn"])
@pytest.mark.parametrize("mode", ["goal", "cmd"])
def test_navi_predictor_matches_jax(mode, track, use_pallas):
    """goal: the mean (world frame) and std of the DiagGaussian; cmd: the logits over the n_ag_cmd commands."""
    cfg, jmodel, params, pmodel, pp, _, mp, ptokens = _setup_for(mode, use_pallas, track)
    args = (pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type)
    with jax_sort_knn():
        want = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, method="predict_navi"))(params, *args, mp)
    with torch.no_grad():
        got = pmodel.predict_navi(*(_t(a) for a in args), ptokens)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if mode == "goal":
        assert tuple(got.mean.shape) == (2, cfg.data.n_ag, 4) and got.mean.dtype == torch.float32
        _close(got.mean, want.mean, "goal mean")
        _close(got.std, want.std, "goal std")
    else:
        assert tuple(got.logits.shape) == (2, cfg.data.n_ag, cfg.data.n_ag_cmd)
        _close(got.logits, want.logits, "cmd logits")


@PALLAS
@pytest.mark.parametrize("add_mode", ["add", "mul"])
def test_step_with_add_navi_latent_matches_jax(add_mode, use_pallas):
    """One policy step (goal navi fused by add / mul, the latent likewise) from each package's own scene encoding:
    the action distribution."""
    cfg, jmodel, params, pmodel, pp, batch, _, _ = _setup_for("goal", use_pallas, add_mode=add_mode)
    w = cfg.model.temp_window_size
    n_sc, n_ag = pp.ag_valid.shape[:2]
    latent = np.random.default_rng(0).standard_normal((n_sc, n_ag, cfg.model.latent_encoder.latent_dim)).astype(
        np.float32)
    scene = (pp.mp_valid, pp.mp_attr, pp.mp_pose, pp.mp_type, pp.tl_valid, pp.tl_attr, pp.tl_pose)
    step = (pp.ag_valid[:, :, -1], pp.ag_valid[:, :, -w:], pp.ag_pose[:, :, -w:], pp.ag_motion[:, :, -w:],
            pp.ag_attr, pp.ag_type, jnp.asarray(latent), jnp.any(pp.ag_valid, -1), pp.gt_navi,
            jnp.any(pp.gt_valid, -1))

    def jax_step(p, scene, step, tl_state):
        mp = jmodel.apply({"params": p}, *scene[:4], method="encode_map")
        tl = jmodel.apply({"params": p}, *scene[4:], mp, method="precompute_tl")
        (valid, hv, hp, hm, attr, typ, lat, lat_valid, navi, navi_valid) = step
        dist = jmodel.apply({"params": p}, ag_valid=valid, hist_ag_valid=hv, hist_ag_pose=hp, hist_ag_motion=hm,
                            hist_tl_state=tl_state, hist_step_invalid=jnp.zeros(w, bool), ag_attr=attr, ag_type=typ,
                            ag_latent=lat, ag_latent_valid=lat_valid, ag_navi=navi, ag_navi_valid=navi_valid,
                            tl_tokens=tl, mp_tokens=mp, method="step")[0]
        return dist.mean, dist.std

    tl_state = pp.tl_state[:, :, -w:].astype(jnp.float32)
    with jax_sort_knn():
        want = jax.jit(jax_step)(params, scene, step, tl_state)
    with torch.no_grad():
        s = [_t(a) for a in scene]
        mp = pmodel.encode_map(*s[:4])
        tl = pmodel.precompute_tl(*s[4:], mp)
        valid, hv, hp, hm, attr, typ, lat, lat_valid, navi, navi_valid = (_t(a) for a in step)
        dist = pmodel.step(valid, hv, hp, hm, attr, typ, lat, lat_valid, navi, navi_valid, tl, mp,
                           hist_tl_state=_t(tl_state), hist_step_invalid=torch.zeros(w, dtype=torch.bool))[0]
    _close(dist.mean, want[0], "action mean")
    _close(dist.std, want[1], "action std")


def test_add_navi_latent_modes_differ_and_refuse_the_unknown():
    """add and mul build an MLP over hidden_dim inputs where cat takes 2 * hidden_dim; an unknown mode raises."""
    from trafficbotsv15_tpu_torch.config import AddNaviLatentCfg
    from trafficbotsv15_tpu_torch.models.heads import AddNaviLatent

    widths = {m: AddNaviLatent(AddNaviLatentCfg(mode=m, n_layer=2), 16, 8).mlp.fc0.weight.shape[1]
              for m in ("add", "mul", "cat")}
    assert widths == {"add": 16, "mul": 16, "cat": 32}
    with pytest.raises(NotImplementedError):
        AddNaviLatent(AddNaviLatentCfg(mode="gate"), 16, 8)


def test_jax_map_tokens_carry_over():
    """The port's MapTokens holds exactly the JAX container's fields."""
    assert {f.name for f in dataclasses.fields(MapTokens)} == set(JaxMapTokens.__dataclass_fields__)
