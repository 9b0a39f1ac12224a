"""PyTorch port: the serving entry point (`serve.py::InteractiveSimulator`) and the rollout's player override,
against the JAX package on the CPU.

The simulator runs at `tests/test_serve.py`'s config with the parity tests' damped weights (gain 0.5, see
`tests/test_torch_slice.py`), in both packages: `reset`, then 10 policy steps, one step that scripts the first
agent valid at reset and 2 more policy steps. JAX's latent and destination draws are handed to the port after
`reset` (JAX keys and torch generators never draw alike). Poses, motion and actions agree within 1e-3 (m, rad, m/s; float32
over 13 closed-loop steps); validity and the TL states, which the TL encoder inside each step predicts, are
identical. Both with use_pallas False and with use_pallas=True, dense_knn_max=16 (B4 in the map encoder at
reset, B2 in the agent decoder every step; the port's plain versions on the CPU, JAX's references).

The rollout's player override: JAX's `joint_future_pred` and the port's K-future rollout, with JAX's draws
injected, both given the same scripted agents; every row agrees at the slice test's tolerances and the
scripted agents take the scripted action exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, set_threads, t2n, to_jnp
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.serve import InteractiveSimulator as JaxSimulator
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu.train import evaluation as jax_eval
from trafficbotsv15_tpu_torch.serve import InteractiveSimulator
from trafficbotsv15_tpu_torch.sim import rollout as port_rollout_lib
from trafficbotsv15_tpu_torch.train import evaluation as port_eval

set_threads()
ATOL, LOGP_ATOL = 1e-3, 1e-4
N_BEFORE, N_AFTER = 10, 2
SCRIPTED = [2.5, -0.1]  # the scripted agent's (acc, yaw_rate), inside the vehicle bounds
STATIC_SAMPLES = ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid")


def _serve_cfg(use_pallas: bool):
    cfg = tiny_config(n_ag=6, n_mp=20, n_tl=6, n_step=13, hidden_dim=32)
    if use_pallas:
        tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=True, dense_knn_max=16)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))
    return cfg


def _script(obs_valid):
    """The scripted step: the first agent valid at reset takes SCRIPTED, every other agent the policy's action."""
    n_ag = obs_valid.shape[1]
    act = {"valid": np.zeros((1, n_ag), bool), "action": np.zeros((1, n_ag, 2), np.float32)}
    act["valid"][0, _agent(obs_valid)] = True
    act["action"][0, _agent(obs_valid)] = SCRIPTED
    return act


def _agent(obs_valid) -> int:
    return int(np.argmax(np.asarray(obs_valid)[0]))


def _episode(sim, reset_args, after_reset=None):
    obs = sim.reset(*reset_args)
    if after_reset is not None:
        after_reset(sim)
    act = _script(obs["valid"])
    outs = [sim.step() for _ in range(N_BEFORE)] + [sim.step(actions=act)] + [sim.step() for _ in range(N_AFTER)]
    return obs, outs, sim.history()


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "use_pallas"])
def episodes(request):
    cfg = _serve_cfg(request.param)
    _, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=1, seed=9)
    with jax_sort_knn():
        jsim = JaxSimulator(cfg, to_jnp(tree))
        jax_run = _episode(jsim, ({k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1)))
    jstatic = dict(zip(STATIC_SAMPLES, jsim._state[6][4:]))

    def inject(sim):
        sim.static.update({k: torch.from_numpy(np.array(v)) for k, v in jstatic.items()})

    psim = InteractiveSimulator(port_cfg(cfg), port_model(cfg, tree), device="cpu")
    port_run = _episode(psim, (batch, torch.Generator().manual_seed(1)), inject)
    return dict(jax=jax_run, port=port_run, sim=psim)


@pytest.mark.parametrize("key,atol", [("pose", ATOL), ("motion", ATOL), ("action", ATOL), ("valid", 0),
                                      ("tl_state", 0)])
def test_simulator_steps_match_jax(episodes, key, atol):
    (_, jouts, jhist), (_, pouts, phist) = episodes["jax"], episodes["port"]
    assert len(pouts) == N_BEFORE + 1 + N_AFTER
    for t, (j, p) in enumerate(zip(jouts, pouts)):
        assert isinstance(p[key], np.ndarray) and p[key].shape == j[key].shape, (t, key)
        if atol:
            np.testing.assert_allclose(p[key], j[key], rtol=0, atol=atol, err_msg=f"step {t}")
        else:
            np.testing.assert_array_equal(p[key], j[key], err_msg=f"step {t}")
    assert phist[key].shape == jhist[key].shape
    if key == "tl_state":  # the TL encoder inside the step predicts, it is not a copy of the log
        assert (phist["tl_state"].sum(-1) == 1).all()


def test_simulator_reset_and_scripted_agent(episodes):
    (jobs, jouts, _), (pobs, pouts, _) = episodes["jax"], episodes["port"]
    for key in ("valid", "pose", "motion"):
        np.testing.assert_array_equal(pobs[key], np.asarray(jobs[key]))
    a = _agent(pobs["valid"])
    assert pobs["valid"][0, a], "no agent is valid at reset"
    scripted = pouts[N_BEFORE]
    np.testing.assert_array_equal(scripted["action"][0, a], np.float32(SCRIPTED))
    before, dt = pouts[N_BEFORE - 1]["motion"][0, a, 0], episodes["sim"].cfg.dynamics.dt
    np.testing.assert_allclose(scripted["motion"][0, a, 0], before + dt * SCRIPTED[0], rtol=1e-6)
    assert not np.array_equal(pouts[N_BEFORE - 1]["action"][0, a], scripted["action"][0, a])
    np.testing.assert_array_equal(np.asarray(jouts[N_BEFORE]["action"])[0, a], np.float32(SCRIPTED))


def test_fetch_false_keeps_tensors_and_history_stacks(episodes):
    sim = episodes["sim"]
    _, pouts, _ = episodes["port"]
    n_steps = len(pouts)
    out = sim.step(fetch=False)
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    assert set(out) == {"valid", "pose", "motion", "tl_state", "action"}
    hist = sim.history()
    n_ag = pouts[0]["pose"].shape[1]
    assert hist["pose"].shape == (1, n_ag, n_steps + 1, 3)
    assert hist["tl_state"].shape[2] == n_steps + 1 and hist["action"].shape == (1, n_ag, n_steps + 1, 2)
    np.testing.assert_array_equal(hist["pose"][:, :, -1], t2n(out["pose"]))
    np.testing.assert_array_equal(hist["pose"][:, :, 0], pouts[0]["pose"])
    assert np.isfinite(hist["pose"]).all()


def test_simulator_needs_reset_and_a_device(monkeypatch):
    from trafficbotsv15_tpu_torch.config import tiny_config as port_tiny_config
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = port_tiny_config(n_ag=6, n_mp=20, n_tl=6, n_step=13, hidden_dim=32)
    model = build_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="call reset"):
        InteractiveSimulator(cfg, model, device="cpu").step()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InteractiveSimulator(cfg, model)


# ------------------------------------------------------------------ the rollout's player override

def _player(n_rows: int, n_ag: int, n_step: int):
    rng = np.random.default_rng(4)
    valid = rng.uniform(size=(n_rows, n_ag, n_step)) < 0.4
    valid[:, 0, 3:] = True  # agent 0 scripted from step 4 on in every row
    action = np.stack([rng.uniform(-3, 3, (n_rows, n_ag, n_step)),
                       rng.uniform(-0.4, 0.4, (n_rows, n_ag, n_step))], -1).astype(np.float32)
    return valid, action


@pytest.fixture(scope="module")
def player_rollouts():
    """JAX's joint_future_pred (jitted; its rollout's buffer and draws captured) and the port's rollout, both
    with the same player override, the port with JAX's draws."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    k = 2
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    valid, action = _player(2 * k, cfg.data.n_ag, cfg.time_step_end)
    samples = ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid", "ag_navi_log_prob")
    captured = {}
    real_jax = jax_rollout_lib.rollout

    def jax_with_player(*args, **kwargs):
        kwargs.update(player_valid=jnp.asarray(valid), player_action=jnp.asarray(action))
        captured.update({name: kwargs[name] for name in samples}, buffer=real_jax(*args, **kwargs))
        return captured["buffer"]

    def jax_run(params, b, key):
        jax_eval.joint_future_pred(cfg, jmodel, params, b, key, n_joint_future=k, check_level=0)
        return captured.pop("buffer"), dict(captured)

    with jax_sort_knn(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rollout_lib, "rollout", jax_with_player)
        jbuf, jsamples = jax.jit(jax_run)(to_jnp(tree), {kk: jnp.asarray(v) for kk, v in batch.items()},
                                          jax.random.PRNGKey(0))
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    pbatch = port_eval.batch_to_device(batch, torch.device("cpu"))
    scene = port_eval.prepare_joint_future(pcfg, pmodel, pbatch)
    real_port = port_rollout_lib.rollout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rollout_lib, "rollout", lambda *a, **kw: real_port(
            *a, **kw, player_valid=torch.from_numpy(valid), player_action=torch.from_numpy(action)))
        pbuf = port_eval.rollout_joint_futures(pcfg, pmodel, pbatch, scene, k, check_level=0,
                                               **{kk: torch.from_numpy(np.array(v)) for kk, v in jsamples.items()})
    return dict(jbuf=jbuf, pbuf=pbuf, valid=valid, action=action)


@pytest.mark.parametrize("field,atol", [("pred_pose", ATOL), ("pred_motion", ATOL), ("pred_action", ATOL),
                                        ("action_log_prob", LOGP_ATOL), ("pred_valid", 0),
                                        ("mask_teacher_forcing", 0), ("tl_state", 0)])
def test_rollout_player_override_matches_jax(player_rollouts, field, atol):
    j = np.asarray(getattr(player_rollouts["jbuf"], field))
    p = t2n(getattr(player_rollouts["pbuf"], field))
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j.astype(p.dtype), rtol=0, atol=atol)


def test_rollout_scripted_agents_take_the_scripted_action(player_rollouts):
    buf, valid, action = player_rollouts["pbuf"], player_rollouts["valid"], player_rollouts["action"]
    scripted = valid & t2n(buf.pred_valid)
    assert scripted[:, 0, 3:].any() and scripted.sum() > 20
    np.testing.assert_array_equal(t2n(buf.pred_action)[scripted], action[scripted])
    jax_action = np.asarray(player_rollouts["jbuf"].pred_action)
    np.testing.assert_array_equal(jax_action[scripted], action[scripted])
