"""PyTorch port: the validation step (`eval/runner.py::make_validate_step`) in the goal and cmd navigation modes
against the JAX package's jitted step, as `tests/test_torch_validate.py` holds the dest mode: reactive replay with
the logged goal / command and its `reactive_replay/*` loss terms (the navi NLL under the goal's DiagGaussian, or of
the one-hot command's index), the K joint futures with JAX's latent and navi draws handed to the port (the cmd draw
as its one-hot on both sides, `tests/torch_navi_common.py`), their rule sums, WOMD post-processing and metrics, the
WOSAC filter and the native realism fields. Tolerances: `tests/test_torch_validate.py`'s (trajectories 1e-3,
scores 1e-4, loss terms, error sums and realism 1e-4 relative, counts exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, set_threads, to_jnp
from test_torch_validate import JF_SAMPLES, LOGP_ATOL, POSE_ATOL, REL, _close
from torch_navi_common import jax_cmd_one_hot, navi_cfg
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import runner as jax_runner
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu_torch.eval import runner as port_runner
from trafficbotsv15_tpu_torch.train import evaluation as port_eval

set_threads()


@pytest.fixture(scope="module", params=["goal", "cmd"])
def step(request):
    cfg = navi_cfg(request.param)
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

    with jax_sort_knn(), jax_cmd_one_hot(request.param == "cmd"):
        jout, draws = jax.jit(step_and_draws)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                              jax.random.PRNGKey(0))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_eval, "sample_joint_futures", lambda *a, **kw: dict(draws))
        pout = port_runner.make_validate_step(pcfg, pmodel, device="cpu")(batch, torch.Generator().manual_seed(0))
    return dict(jout=jout, pout=pout, draws=draws, mode=request.param)


@pytest.mark.parametrize("entry", ["loss_metrics", "err_sums", "rr_rule", "jf_rule", "womd_metric_vals",
                                   "womd_rr_metric_vals", "wosac_realism"])
def test_navi_validate_step_sums_and_metrics_match_jax(step, entry):
    got, want = step["pout"][entry], step["jout"][entry]
    assert set(got) == set(want)
    for key, val in want.items():
        if entry in ("rr_rule", "jf_rule") or "miss_rate" in key:
            _close(got[key], val, msg=key)
        elif entry.startswith("womd"):
            _close(got[key], val, atol=POSE_ATOL, msg=key)
        else:
            _close(got[key], val, atol=1e-6, rtol=REL, msg=key)
    if entry == "loss_metrics":
        assert float(got["reactive_replay/navi_loss"]) != 0.0


@pytest.mark.parametrize("entry,atol", [("womd_trajs", POSE_ATOL), ("womd_scores", LOGP_ATOL),
                                        ("wosac_trajs", POSE_ATOL), ("womd_rr_trajs", POSE_ATOL),
                                        ("womd_rr_scores", LOGP_ATOL)])
def test_navi_validate_step_trajectories_match_jax(step, entry, atol):
    _close(step["pout"][entry], step["jout"][entry], atol=atol, msg=entry)


def test_navi_validate_step_draws_take_the_encoders_form(step):
    """The joint futures' navi the step rolls out with: goals [n, n_ag, 4], commands one-hot."""
    navi = step["draws"]["ag_navi"]
    if step["mode"] == "goal":
        assert navi.shape[-1] == 4 and navi.dtype == torch.float32
    else:
        assert navi.dtype == torch.bool and (navi.sum(-1) == 1).all()
