"""PyTorch port: the validation step and serving of the scene-centric model (`pairwise_relative=False`) against the
JAX package, on the CPU.

  - the validation step (`eval/runner.py::make_validate_step`: reactive replay and its loss, the joint futures with
    JAX's draws injected, rule counts, WOMD and WOSAC metrics) in the goal and stop-line arm with use_pallas
    (`tests/test_torch_scene_centric.py::arm_cfg`), at `tests/test_torch_validate.py`'s tolerances;
  - `serve.py::InteractiveSimulator` at `tests/test_torch_serve.py`'s config and damped weights, scene-centric, with
    use_pallas False and True: JAX's latent and destination injected after `reset`, then 10 policy steps, a
    scripted one and 2 more, poses, motion and actions to 1e-3, validity and TL states exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, set_threads, to_jnp
from test_torch_scene_centric import arm_cfg
from test_torch_serve import ATOL, STATIC_SAMPLES, _episode, _serve_cfg
from test_torch_validate import JF_SAMPLES, LOGP_ATOL, POSE_ATOL, REL, _close
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import runner as jax_runner
from trafficbotsv15_tpu.serve import InteractiveSimulator as JaxSimulator
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu_torch.eval import runner as port_runner
from trafficbotsv15_tpu_torch.serve import InteractiveSimulator
from trafficbotsv15_tpu_torch.train import evaluation as port_eval

set_threads()


@pytest.fixture(scope="module")
def step():
    cfg = arm_cfg("goal_stop")
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    jstep = jax_runner.make_validate_step(cfg, jmodel)

    def step_and_draws(params, b, key):
        rollouts, log_probs = [], []
        real_rollout, real_log_prob = jax_rollout_lib.rollout, jax_rollout_lib.compute_log_prob

        def rollout(*args, **kwargs):
            rollouts.append({k: kwargs[k] for k in JF_SAMPLES})
            return real_rollout(*args, **kwargs)

        def compute_log_prob(buf, latent_log_prob):
            log_probs.append(latent_log_prob)
            return real_log_prob(buf, latent_log_prob)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rollout_lib, "rollout", rollout)
            mp.setattr(jax_rollout_lib, "compute_log_prob", compute_log_prob)
            out = jstep(params, b, key)
        return out, dict(rollouts[1], latent_log_prob=log_probs[0])

    with jax_sort_knn():
        jout, draws = jax.jit(step_and_draws)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                              jax.random.PRNGKey(0))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_eval, "sample_joint_futures", lambda *a, **kw: dict(draws))
        pout = port_runner.make_validate_step(pcfg, pmodel, device="cpu")(batch, torch.Generator().manual_seed(0))
    return dict(jout=jout, pout=pout)


@pytest.mark.parametrize("entry", ["loss_metrics", "err_sums", "rr_rule", "jf_rule", "womd_metric_vals",
                                   "womd_rr_metric_vals", "wosac_realism"])
def test_validate_step_sums_and_metrics_match_jax(step, entry):
    got, want = step["pout"][entry], step["jout"][entry]
    assert set(got) == set(want)
    for key, val in want.items():
        if entry in ("rr_rule", "jf_rule") or "miss_rate" in key:
            _close(got[key], val, msg=key)
        elif entry.startswith("womd"):
            _close(got[key], val, atol=POSE_ATOL, msg=key)
        else:
            _close(got[key], val, atol=1e-6, rtol=REL, msg=key)


@pytest.mark.parametrize("entry,atol", [("womd_trajs", POSE_ATOL), ("womd_scores", LOGP_ATOL),
                                        ("wosac_trajs", POSE_ATOL), ("womd_rr_trajs", POSE_ATOL),
                                        ("womd_rr_scores", LOGP_ATOL)])
def test_validate_step_trajectories_match_jax(step, entry, atol):
    _close(step["pout"][entry], step["jout"][entry], atol=atol, msg=entry)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "use_pallas"])
def episodes(request):
    cfg = _serve_cfg(request.param)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pairwise_relative=False))
    _, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=1, seed=9)
    with jax_sort_knn():
        jsim = JaxSimulator(cfg, to_jnp(tree))
        jax_run = _episode(jsim, ({k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1)))
    jstatic = dict(zip(STATIC_SAMPLES, jsim._state[6][4:]))

    def inject(sim):
        sim.static.update({k: torch.from_numpy(np.array(v)) for k, v in jstatic.items()})

    psim = InteractiveSimulator(port_cfg(cfg), port_model(cfg, tree), device="cpu")
    return dict(jax=jax_run, port=_episode(psim, (batch, torch.Generator().manual_seed(1)), inject))


@pytest.mark.parametrize("key,atol", [("pose", ATOL), ("motion", ATOL), ("action", ATOL), ("valid", 0),
                                      ("tl_state", 0)])
def test_scene_centric_simulator_steps_match_jax(episodes, key, atol):
    (jobs, jouts, _), (pobs, pouts, _) = episodes["jax"], episodes["port"]
    for k in ("valid", "pose", "motion"):
        np.testing.assert_array_equal(pobs[k], np.asarray(jobs[k]))
    assert len(pouts) == len(jouts) > 10
    for t, (j, p) in enumerate(zip(jouts, pouts)):
        if atol:
            np.testing.assert_allclose(p[key], np.asarray(j[key]), rtol=0, atol=atol, err_msg=f"step {t}")
        else:
            np.testing.assert_array_equal(p[key], np.asarray(j[key]), err_msg=f"step {t}")
