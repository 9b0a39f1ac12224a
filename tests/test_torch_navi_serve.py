"""PyTorch port: `serve.py::InteractiveSimulator.reset` and its steps in the goal and cmd navigation modes against the
JAX package's simulator, at `tests/test_torch_serve.py`'s config and damped weights.

`reset` draws the navi from the predictor; JAX's draw comes from its key, so the test rebuilds it on the port's
side from the port's own prediction of the reset's history and JAX's noise (`InteractiveSimulator` keys: reset
splits (encode, carry), encode splits (latent, navi)): the goal (mean + std * noise) to 1e-4, the command (argmax of
logits + Gumbel noise) exactly, as JAX's one-hot (`tests/torch_navi_common.py`); the navi's validity exactly. Then
JAX's latent and navi are handed to the port and 6 policy steps agree: poses, motion and actions to 1e-3, validity
and TL states exactly (`tests/test_torch_serve.py`'s tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, set_threads, t2n, to_jnp
from test_torch_serve import ATOL, STATIC_SAMPLES, _serve_cfg
from torch_navi_common import jax_cmd_one_hot
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.serve import InteractiveSimulator as JaxSimulator
from trafficbotsv15_tpu_torch.serve import InteractiveSimulator

set_threads()
N_STEPS = 6


@pytest.fixture(scope="module", params=["goal", "cmd"])
def sims(request):
    import dataclasses

    cfg = _serve_cfg(False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, navi_mode=request.param))
    _, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=1, seed=9)
    key = jax.random.PRNGKey(1)
    with jax_sort_knn(), jax_cmd_one_hot(request.param == "cmd"):
        jsim = JaxSimulator(cfg, to_jnp(tree))
        jobs = jsim.reset({k: jnp.asarray(v) for k, v in batch.items()}, key)
        jouts = [jsim.step() for _ in range(N_STEPS)]
    jstatic = {k: torch.from_numpy(np.array(v)) for k, v in zip(STATIC_SAMPLES, jsim._state[6][4:])}
    k_navi = jax.random.split(jax.random.split(key)[0])[1]

    psim = InteractiveSimulator(port_cfg(cfg), port_model(cfg, tree), device="cpu")
    pobs = psim.reset(batch, torch.Generator().manual_seed(1))
    own = dict(psim.static)
    psim.static.update(jstatic)
    pouts = [psim.step() for _ in range(N_STEPS)]
    return dict(mode=request.param, cfg=cfg, psim=psim, batch=batch, k_navi=k_navi, jstatic=jstatic, own=own,
                jobs=jobs, pobs=pobs, jouts=jouts, pouts=pouts)


def test_reset_navi_matches_jax(sims):
    from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
    from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device

    psim, cfg = sims["psim"], sims["psim"].cfg
    b = batch_to_device(sims["batch"], torch.device("cpu"))
    pp = pre_processing(b, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode, n_step_hist=cfg.n_step_hist,
                        training=True)
    with torch.no_grad():
        dist = psim.model.predict_navi(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type,
                                       psim.static["mp_tokens"])
    want, valid = sims["jstatic"]["ag_navi"], sims["jstatic"]["ag_navi_valid"]
    np.testing.assert_array_equal(sims["own"]["ag_navi_valid"].numpy(), valid.numpy())
    if sims["mode"] == "goal":
        noise = torch.from_numpy(np.array(jax.random.normal(sims["k_navi"], tuple(dist.mean.shape), jnp.float32)))
        np.testing.assert_allclose(t2n(dist.rsample(noise)), want.numpy(), rtol=0, atol=1e-4)
        assert tuple(sims["own"]["ag_navi"].shape) == tuple(want.shape)
    else:
        noise = torch.from_numpy(np.array(jax.random.gumbel(sims["k_navi"], tuple(dist.logits.shape), jnp.float32)))
        got = torch.nn.functional.one_hot(dist.rsample(noise).long(), cfg.data.n_ag_cmd).bool()
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        own = sims["own"]["ag_navi"]  # the port's own draw: a one-hot command per agent
        assert own.dtype == torch.bool and (own.sum(-1) == 1).all()


@pytest.mark.parametrize("key,atol", [("pose", ATOL), ("motion", ATOL), ("action", ATOL), ("valid", 0),
                                      ("tl_state", 0)])
def test_steps_with_the_jax_navi_match_jax(sims, key, atol):
    for key_obs in ("valid", "pose", "motion"):
        np.testing.assert_array_equal(sims["pobs"][key_obs], np.asarray(sims["jobs"][key_obs]))
    for t, (j, p) in enumerate(zip(sims["jouts"], sims["pouts"])):
        if atol:
            np.testing.assert_allclose(p[key], np.asarray(j[key]), rtol=0, atol=atol, err_msg=f"step {t}")
        else:
            np.testing.assert_array_equal(p[key], np.asarray(j[key]), err_msg=f"step {t}")
