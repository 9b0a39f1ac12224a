"""PyTorch port: the config dict, SWA / EMA, gradient accumulation and the checkpoint manager, against the JAX
package where it has the function, and the JAX package's checkpoints carried into the port.

  - `config_to_dict` gives the JAX package's keys and values, and both packages' `config_from_dict` read it back
    (exact);
  - `train/swa.py` against JAX `train/swa.py` on the same numpy parameter sequences (1e-6 relative + 1e-7);
  - `GradAccumulator` with the optimizer against `optax.MultiSteps(make_optimizer(...))` on the same numpy gradient
    sequences, k = 2 and 3, `lr_navi` split and the clip active: the parameters after every call agree to 1e-6
    relative + 1e-9 (float32; optax adds the update to the parameter once, AdamW decays and adds apart);
  - `CheckpointManager`: round trip (exact), the best score's ranking and its survival of a restart, the morph
    for submission, the crash windows of the asynchronous save, a failed write;
  - the migration path of a JAX checkpoint into the port is `test_torch_checkpoint_migration.py`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import set_threads
from trafficbotsv15_tpu import config as jax_config
from trafficbotsv15_tpu.train import swa as jax_swa
from trafficbotsv15_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from trafficbotsv15_tpu_torch import config as port_config
from trafficbotsv15_tpu_torch.parallel.mesh import ShardedParams
from trafficbotsv15_tpu_torch.train import swa
from trafficbotsv15_tpu_torch.train.checkpoint import CheckpointManager
from trafficbotsv15_tpu_torch.train.optimizer import GradAccumulator, clip_by_global_norm, make_optimizer

set_threads()


def T(x):
    return torch.from_numpy(np.asarray(x))


# -- the config dict ------------------------------------------------------------------------------------------------
@pytest.mark.parametrize("preset", ["leaderboard_config", "tiny_config", "scaled_config"])
def test_config_dict_matches_jax_and_round_trips(preset):
    ours = port_config.config_to_dict(getattr(port_config, preset)())
    ref = jax_config.config_to_dict(getattr(jax_config, preset)())
    assert ours == ref
    assert port_config.config_from_dict(ours) == getattr(port_config, preset)()
    assert jax_config.config_from_dict(json.loads(json.dumps(ours))) == getattr(jax_config, preset)()
    # a checkpoint's last.json: JSON turns tuples into lists, which read back as tuples
    assert port_config.config_from_dict(json.loads(json.dumps(ref))) == getattr(port_config, preset)()


def test_config_from_dict_reads_partial_dicts_as_jax_does():
    d = {"seed": 7, "model": {"hidden_dim": 64, "tf_cfg": {"n_head": 8}}, "optimizer": {"betas": [0.8, 0.9]},
         "womd_post": {"mtr_nms_thresh": []}, "not_a_field": 1, "data": {"n_ag": 16, "gone": 2}}
    ours = port_config.config_to_dict(port_config.config_from_dict(d))
    assert ours == jax_config.config_to_dict(jax_config.config_from_dict(d))
    assert ours["model"]["tf_cfg"]["d_model"] == 128 and ours["optimizer"]["betas"] == (0.8, 0.9)


# -- SWA and EMA ----------------------------------------------------------------------------------------------------
def test_swa_and_ema_match_jax():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), ()]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    seq = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(6)]
    start, decay = 2, 0.9

    j_swa = jax_swa.swa_init({str(i): jnp.asarray(p) for i, p in enumerate(p0)})
    j_ema = jax_swa.ema_init({str(i): jnp.asarray(p) for i, p in enumerate(p0)})
    params = [T(p.copy()) for p in p0]
    state, ema = swa.swa_init(params), swa.ema_init(params)
    # before any step folds in, the SWA parameters are the fallback
    assert all(torch.equal(a, p) for a, p in zip(swa.swa_params(state, params), params))
    for step, ps in enumerate(seq):
        jp = {str(i): jnp.asarray(p) for i, p in enumerate(ps)}
        j_swa = jax_swa.swa_update(j_swa, jp, jnp.asarray(step, jnp.float32), start)
        j_ema = jax_swa.ema_update(j_ema, jp, decay)
        for t, p in zip(params, ps):
            t.copy_(T(p))
        swa.swa_update(state, params, step, start)
        swa.ema_update(ema, params, decay)
        assert float(state[1]) == float(j_swa[1])
        got = swa.swa_params(state, params)
        want = jax_swa.swa_params(j_swa, jp)
        for i in range(len(shapes)):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[str(i)]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ema[i].numpy(), np.asarray(j_ema[str(i)]), rtol=1e-6, atol=1e-7)
    assert float(state[1]) == len(seq) - start
    np.testing.assert_allclose(state[0][0].numpy(), np.mean([s[0] for s in seq[start:]], axis=0), rtol=1e-6, atol=1e-7)


def test_ema_is_a_float32_copy():
    p = [torch.ones(3, dtype=torch.float32)]
    e = swa.ema_init(p)
    p[0].add_(1.0)
    assert e[0].dtype == torch.float32 and torch.equal(e[0], torch.ones(3))


# -- gradient accumulation ------------------------------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """Six calls; every k-th updates. The first gradients are large, so the clip acts on their mean."""
    from trafficbotsv15_tpu.config import OptimizerCfg

    jcfg = OptimizerCfg(lr=2e-3, lr_navi=1e-3, scheduler_step_epochs=1, accumulate_grad_batches=k)
    rng = np.random.default_rng(k)
    shapes = {"navi_predictor": {"w": (4, 3), "b": (3,)}, "ag_encoder": {"w": (5, 4)}, "action_head": {"b": (2,)}}
    params = {top: {n: rng.normal(size=s).astype(np.float32) for n, s in d.items()} for top, d in shapes.items()}
    tx = jax_make_optimizer(jcfg, steps_per_epoch=1)
    assert isinstance(tx, optax.MultiSteps)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    model = torch.nn.ModuleDict({top: torch.nn.ParameterDict({n: torch.nn.Parameter(T(v)) for n, v in d.items()})
                                 for top, d in params.items()})
    pcfg = port_config.OptimizerCfg(**dataclasses.asdict(jcfg))
    opt, schedule = make_optimizer(pcfg, model.named_parameters(), steps_per_epoch=1)
    placed = ShardedParams(model, {})  # every parameter replicated: the clip's squared norms
    acc = GradAccumulator(model.parameters(), k)
    updates = 0
    for call in range(6):
        scale = 8.0 if call < k else 0.5
        grads = {top: {n: (scale * rng.normal(size=s)).astype(np.float32) for n, s in d.items()}
                 for top, d in shapes.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for top, d in grads.items():
            for n, v in d.items():
                model[top][n].grad = T(v)
        if acc.add():
            clip_by_global_norm(opt.param_groups, pcfg.grad_clip_norm, placed.group_squares(opt.param_groups))
            opt.step()
            schedule.step()
            updates += 1
        assert acc.mini_step == (call + 1) % k
        for top, d in shapes.items():
            for n in d:
                np.testing.assert_allclose(model[top][n].detach().numpy(), np.asarray(jparams[top][n]),
                                           rtol=1e-6, atol=1e-9, err_msg=f"call {call}: {top}.{n}")
    # the schedule counted updates, not calls (MultiSteps runs the inner chain on the k-th call only)
    assert updates == 6 // k and schedule.last_epoch == updates and int(state.gradient_step) == updates


def test_accumulator_state_round_trips():
    p = torch.nn.Parameter(torch.zeros(3))
    acc = GradAccumulator([p], 3)
    p.grad = torch.tensor([3.0, 6.0, 9.0])
    assert not acc.add()
    other = GradAccumulator([p], 3)
    other.load_state_dict(acc.state_dict())
    p.grad = torch.tensor([1.0, 2.0, 3.0])
    assert not other.add()
    p.grad = torch.tensor([2.0, 4.0, 6.0])
    assert other.add() and torch.equal(p.grad, torch.tensor([2.0, 4.0, 6.0]))
    assert other.mini_step == 0 and torch.equal(other.acc[0], torch.zeros(3))


# -- the checkpoint manager -----------------------------------------------------------------------------------------
def _state(v: float):
    return {"model": {"w": torch.full((4,), v), "b": torch.arange(3.0)}, "optimizer": {"state": {0: {"step": 1}},
                                                                                    "param_groups": [{"lr": 0.1}]}}


def test_checkpoint_round_trip_ranking_and_morph(tmp_path):
    cfg = port_config.tiny_config()
    mgr = CheckpointManager(str(tmp_path))
    live = _state(1.0)
    mgr.save_last(live, cfg, {"step": 7})
    live["model"]["w"].add_(5.0)  # the save took its copy when save_last returned
    state, cfg2, meta = mgr.restore("last")
    assert meta == {"step": 7} and cfg2 == cfg and torch.equal(state["model"]["w"], torch.ones(4))
    assert state["optimizer"] == {"state": {0: {"step": 1}}, "param_groups": [{"lr": 0.1}]}
    info = json.loads((tmp_path / "last.json").read_text())  # the JAX package reads the saved config
    assert jax_config.config_from_dict(info["config"]) == jax_config.tiny_config()

    assert mgr.save_best(_state(1.0), cfg, 1.0, {"step": 1})
    assert not mgr.save_best(_state(2.0), cfg, 2.0, {"step": 2})
    assert mgr.save_best(_state(3.0), cfg, 0.5, {"step": 3})
    state, cfg3, meta = mgr.restore("best", config_overrides={"n_joint_future_wosac": 128, "model": {"hidden_dim": 64}})
    assert meta == {"step": 3, "score": 0.5} and torch.equal(state["model"]["w"], torch.full((4,), 3.0))
    assert cfg3.n_joint_future_wosac == 128 and cfg3.model.hidden_dim == 64 and cfg3.model.tf_cfg == cfg.model.tf_cfg

    resumed, _, _ = mgr.restore_resume({"model", "ema"})
    assert set(resumed) == {"model"}


def test_best_score_survives_a_restart(tmp_path):
    cfg = port_config.tiny_config()
    assert CheckpointManager(str(tmp_path)).save_best(_state(1.0), cfg, 1.5, {})
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.best_score == 1.5
    assert not fresh.save_best(_state(2.0), cfg, 2.0, {})
    assert torch.equal(fresh.restore("best")[0]["model"]["w"], torch.ones(4))
    assert fresh.save_best(_state(3.0), cfg, 1.0, {})
    assert CheckpointManager(str(tmp_path)).best_score == 1.0


def test_async_save_crash_windows(tmp_path):
    """An unfinalised save is lost on a restart and the previous checkpoint restores; a leftover `.tmp` breaks
    nothing; a crash between the renames (only `.old` left) restores from `.old`."""
    cfg = port_config.tiny_config()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_last(_state(1.0), cfg, {"step": 1})
    mgr.wait()
    mgr.save_last(_state(2.0), cfg, {"step": 2})
    mgr._pending[1].join()  # the write is on disk as last.tmp, never swapped in: the process "dies" here
    assert (tmp_path / "last.tmp").exists()
    fresh = CheckpointManager(str(tmp_path))
    state, _, meta = fresh.restore("last")
    assert meta["step"] == 1 and torch.equal(state["model"]["w"], torch.ones(4))
    fresh.save_last(_state(3.0), cfg, {"step": 3})
    fresh.wait()
    state, _, meta = fresh.restore("last")
    assert meta["step"] == 3 and torch.equal(state["model"]["w"], torch.full((4,), 3.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last", "last.json"]

    (tmp_path / "last").rename(tmp_path / "last.old")  # the crash between the two renames
    state, _, meta = CheckpointManager(str(tmp_path)).restore("last")
    assert torch.equal(state["model"]["w"], torch.full((4,), 3.0))
    again = CheckpointManager(str(tmp_path))
    again.save_last(_state(4.0), cfg, {"step": 4})
    again.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last", "last.json"]
    assert torch.equal(again.restore("last")[0]["model"]["w"], torch.full((4,), 4.0))


def test_failed_write_raises_when_finalised(tmp_path, monkeypatch):
    cfg = port_config.tiny_config()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_last(_state(1.0), cfg, {"step": 1})
    mgr.wait()

    def broken_save(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    mgr.save_last(_state(2.0), cfg, {"step": 2})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    monkeypatch.undo()
    assert CheckpointManager(str(tmp_path)).restore("last")[2]["step"] == 1
