"""PyTorch port: the training entry point (`run.py`) on the CPU, and what a real run adds to the step, against the
JAX package.

Against the JAX package (tiny_config, random weights of gain 0.5 from a numpy seed, the JAX draws injected):
  - `parse_overrides` / `apply_overrides` give the JAX package's dicts and configs (exact);
  - `error_reset_mask` on random states (exact); the eval rollout with thresholds set, as reactive replay runs
    it over the whole logged horizon (`teacher_forcing_reactive_replay`; joint futures see only the history, where
    every agent is forced anyway): every buffer field and the loss terms (`test_torch_validate.py`'s harness and
    tolerances: 1e-3 on poses, 1e-4 on log probabilities, 1e-4 relative on the losses, flags and forcing exact);
    one training step with thresholds set in `teacher_forcing_training` (`test_torch_train_grad.py`'s: the loss
    terms to 1e-5 relative, every gradient to 1e-4 of its largest plus 1e-7);
  - two accumulated calls and one update (`accumulate_grad_batches=2`) through `make_train_step` against JAX's
    jitted step with `optax.MultiSteps`: the first call leaves the parameters untouched, the loss terms agree to
    1e-5 relative, each parameter after the update to 1e-4 of its largest value + 1e-7 (float32 gradients agree
    to ~5e-6 of their largest; where a gradient is near Adam's eps of 1e-8 that moves its step by ~1e-6, a few
    times 1e-4 of a small bias element: measured 1.5e-6 on 2 of 64 values of one).
The entry point, `device=cpu` (each case mirrors one of `tests/test_runner_ckpt.py`): `fit` takes bit for bit the
steps `make_train_step` takes by hand, with EMA and SWA; a resumed fit ends bit for bit where an uninterrupted one
does, accumulation buffers included; SIGTERM exits 143 and a resume adds one step; `action=validate` and
`action=test` run from the checkpoints; the keys without a counterpart raise.
"""

import dataclasses
import json
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_grads_match, assert_loss_matches, jax_model_params, jax_sort_knn,
                                jax_training_noise, no_dropout, port_cfg, port_model, set_threads, t2n, to_jnp,
                                train_step_parity)
from test_torch_validate import _assert_buffers, _assert_losses
from trafficbotsv15_tpu import config as jax_config
from trafficbotsv15_tpu import run as jax_run
from trafficbotsv15_tpu.config import tiny_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.sim.teacher_forcing import error_reset_mask as jax_error_reset_mask
from trafficbotsv15_tpu.train import evaluation as jax_eval
from trafficbotsv15_tpu.train.losses import training_loss as jax_training_loss
from trafficbotsv15_tpu.train import pipeline as jax_pipeline
from trafficbotsv15_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from trafficbotsv15_tpu_torch import config as port_config
from trafficbotsv15_tpu_torch import run
from trafficbotsv15_tpu_torch.config import TeacherForcingCfg
from trafficbotsv15_tpu_torch.sim import rollout as port_rollout
from trafficbotsv15_tpu_torch.sim.teacher_forcing import error_reset_mask
from trafficbotsv15_tpu_torch.train import evaluation as port_eval
from trafficbotsv15_tpu_torch.train import swa
from trafficbotsv15_tpu_torch.train.checkpoint import CheckpointManager
from trafficbotsv15_tpu_torch.train.losses import training_loss
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.train.pipeline import build_model, make_train_step
from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

set_threads()
REPO = Path(__file__).resolve().parent.parent
THRESHOLDS = dict(threshold_xy=0.3, threshold_yaw=5.0, threshold_spd=0.5)


# -- overrides ------------------------------------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["model.hidden_dim=64", "optimizer.lr=1e-3", "swa=true"],
    ["optimizer.betas=[0.8, 0.9]", "teacher_forcing_training.threshold_xy=2.5", "batch_size_train=4", "noeq"],
    ["model.tf_cfg.use_pallas=true", "ops.knn_impl=sort", "ema_decay=0.5", "not_a_field=abc", "seed=7"],
])
def test_overrides_match_jax(argv):
    assert run.parse_overrides(argv) == jax_run.parse_overrides(argv)
    ours = run.apply_overrides(port_config.tiny_config(), run.parse_overrides(argv))
    ref = jax_run.apply_overrides(tiny_config(), jax_run.parse_overrides(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_main_keeps_its_own_keys_apart_from_the_config(monkeypatch, tmp_path):
    """`data=synthetic` picks the loader while `data.n_ag=4` sets the config's DataCfg."""
    seen = {}
    monkeypatch.setattr(run, "fit", lambda cfg, *a, **kw: seen.update(cfg=cfg, **kw) or (None, None, False))
    run.main(["action=fit", "device=cpu", "preset=tiny", "data=synthetic", "data.n_ag=4", "max_steps=3",
              f"ckpt_dir={tmp_path}", "optimizer.accumulate_grad_batches=2"])
    assert seen["cfg"].data.n_ag == 4 and seen["cfg"].optimizer.accumulate_grad_batches == 2
    assert seen["max_steps"] == 3 and seen["device"].type == "cpu" and seen["ckpt_dir"] == str(tmp_path)


# -- presets ---------------------------------------------------------------------------------------------------------
def test_scaled_preset_gives_the_jax_scaled_config(monkeypatch, tmp_path):
    """`preset=scaled` reaches `fit` with the JAX package's `scaled_config()`, field for field."""
    seen = {}
    monkeypatch.setattr(run, "make_dataloaders", lambda *a, **kw: (None, None))
    monkeypatch.setattr(run, "fit", lambda cfg, *a, **kw: seen.update(cfg=cfg) or (None, None, False))
    run.main(["action=fit", "device=cpu", "preset=scaled", f"ckpt_dir={tmp_path}"])
    assert port_config.config_to_dict(seen["cfg"]) == jax_config.config_to_dict(jax_config.scaled_config())
    assert seen["cfg"].time_step_end == 120 and seen["cfg"].model.tf_cfg.n_head == 8


@pytest.mark.parametrize("preset", ["flagship", "Scaled", ""])
def test_unknown_preset_raises(monkeypatch, tmp_path, preset):
    """Where JAX's run.py falls back to the leaderboard config, the port refuses and names its presets."""
    monkeypatch.setattr(run, "fit", lambda *a, **kw: pytest.fail("fit reached with an unknown preset"))
    with pytest.raises(ValueError, match="leaderboard, tiny, scaled"):
        run.main(["action=fit", "device=cpu", f"preset={preset}", f"ckpt_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_params_from_jax_carries_a_scaled_config_tree_both_ways():
    """A JAX `scaled_config()` parameter tree (its shapes, random values) fills every parameter of the port's model
    at `preset=scaled` and every leaf lands in one (`load_state_dict(strict=True)`), the values unchanged."""
    _, tree = jax_model_params(jax_config.scaled_config(), seed=0)
    model = build_model(run.preset_config("scaled"), device="cpu")
    state = params_from_jax(tree)
    model.load_state_dict(state, strict=True)
    params = dict(model.named_parameters())
    assert set(params) == set(state) and len(jax.tree_util.tree_leaves(tree)) == len(state)
    assert all(torch.equal(params[n], v) for n, v in state.items())
    assert sum(p.numel() for p in params.values()) > 30e6  # the ~40M-parameter preset


# -- the error-threshold reset --------------------------------------------------------------------------------------
@pytest.mark.parametrize("thresholds", [dict(threshold_xy=1.0), dict(threshold_yaw=20.0), dict(threshold_spd=0.7),
                                        THRESHOLDS, {}])
def test_error_reset_mask_matches_jax(thresholds):
    from trafficbotsv15_tpu.config import TeacherForcingCfg as JaxTeacherForcingCfg

    rng = np.random.default_rng(len(thresholds))
    shape = (3, 40)
    valid, gt_valid = rng.uniform(size=shape) < 0.8, rng.uniform(size=shape) < 0.8
    pose = rng.normal(size=shape + (3,)).astype(np.float32) * [1.0, 1.0, 3.0]
    motion = rng.normal(size=shape + (3,)).astype(np.float32)
    gt_pose = (pose + rng.normal(size=shape + (3,)) * [0.8, 0.8, 0.5]).astype(np.float32)
    gt_motion = (motion + rng.normal(size=shape + (3,)) * 0.6).astype(np.float32)
    args = (valid, pose, motion, gt_valid, gt_pose, gt_motion)
    got = error_reset_mask(TeacherForcingCfg(**thresholds), *[torch.from_numpy(np.asarray(a)) for a in args])
    want = jax_error_reset_mask(JaxTeacherForcingCfg(**thresholds), *[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() == bool(thresholds)


def _with_thresholds(cfg, field):
    return dataclasses.replace(cfg, **{field: dataclasses.replace(getattr(cfg, field), **THRESHOLDS)})


@pytest.fixture(scope="module")
def reset_replay():
    """JAX reactive replay (jitted) and its loss, and the port's, with the error thresholds set; the port's forcing
    mask without them."""
    cfg = _with_thresholds(tiny_config(), "teacher_forcing_reactive_replay")
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)

    def replay(params, b, key):
        pp, buf, navi_pred, post, prior = jax_eval.reactive_replay(cfg, jmodel, params, b, key)
        return buf, jax_training_loss(cfg.training_metrics, buf, pp.ag_role, navi_pred, pp.gt_navi, post, prior,
                                      prefix="reactive_replay")[1]

    with jax_sort_knn():
        jbuf, jloss = jax.jit(replay)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(0))
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    pp, pbuf, navi_pred, post, prior = port_eval.reactive_replay(pcfg, pmodel, batch, device="cpu")
    _, ploss = training_loss(pcfg.training_metrics, pbuf, pp.ag_role, navi_pred, pp.gt_navi, post, prior,
                             prefix="reactive_replay")
    plain = port_eval.reactive_replay(port_cfg(tiny_config()), pmodel, batch, device="cpu")[1]
    return dict(jbuf=jbuf, jloss=jloss, pbuf=pbuf, ploss=ploss, plain_forcing=plain.mask_teacher_forcing)


def test_rollout_with_error_reset_matches_jax(reset_replay):
    _assert_buffers(reset_replay["jbuf"], reset_replay["pbuf"])
    _assert_losses(reset_replay["ploss"], reset_replay["jloss"])


def test_rollout_error_reset_forces_agents_back_to_the_log(reset_replay):
    forced, plain = reset_replay["pbuf"].mask_teacher_forcing, reset_replay["plain_forcing"]
    assert bool((plain <= forced).all()) and int(forced.sum()) > int(plain.sum())


def test_training_step_with_error_reset_matches_jax(monkeypatch):
    fired = []
    real = port_rollout.error_reset_mask
    monkeypatch.setattr(port_rollout, "error_reset_mask",
                        lambda *a: (lambda m: fired.append(int(m.sum())) or m)(real(*a)))
    out = train_step_parity(no_dropout(_with_thresholds(tiny_config(), "teacher_forcing_training")))
    assert_loss_matches(out)
    assert_grads_match(out)
    # once per rollout step in the forward and once in its recompute in the backward
    assert len(fired) == 2 * tiny_config().time_step_end and sum(fired) > 0


# -- accumulation: the whole step against JAX's jitted step ---------------------------------------------------------
def test_accumulated_update_matches_jax_step():
    """Two calls of the port's `make_train_step` at accumulate_grad_batches=2 against JAX's jitted step (MultiSteps):
    each call's loss terms; each call's gradients against those JAX's step folds in (its accumulator after a call
    from the starting state); the first call leaves the parameters untouched; the update gives what optax's
    MultiSteps chain gives from the port's own gradients. Adam turns a gradient near 0 or near its eps of 1e-8 into
    a step of up to lr whatever its size, so the parameters are not compared with JAX's directly: one element of
    an attention weight moved by 2.9e-5 (1.06e-4 of the tensor's largest value) on a gradient that agreed to the
    gradient tolerance."""
    import optax

    cfg = no_dropout(tiny_config())
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, accumulate_grad_batches=2))
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batches = [make_batch(cfg.data, n_sc=2, seed=s) for s in (1, 2)]
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    tx = jax_make_optimizer(cfg.optimizer, steps_per_epoch=4)
    params0, state0 = to_jnp(tree), tx.init(to_jnp(tree))
    jstep = jax.jit(jax_pipeline.make_train_step(cfg, jmodel, tx))
    jb = [{n: jnp.asarray(v) for n, v in b.items()} for b in batches]
    with jax_sort_knn():
        params1, state1, m1 = jstep(params0, state0, jb[0], keys[0], 0)
        _, state_b, _ = jstep(params0, state0, jb[1], keys[1], 0)  # what the second call folds in
        params2, _, m2 = jstep(params1, state1, jb[1], keys[1], 0)
    jgrads = [params_from_jax(jax.tree_util.tree_map(np.asarray, st.acc_grads)) for st in (state1, state_b)]
    jmetrics = [{n: float(v) for n, v in m.items()} for m in (m1, m2)]

    pcfg = port_cfg(cfg)
    model = port_model(cfg, tree)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, schedule = make_optimizer(pcfg.optimizer, model.named_parameters(), steps_per_epoch=4)
    step = make_train_step(pcfg, model, opt, schedule, device="cpu")
    pgrads, real_add = [], step.accumulator.add

    def add():
        pgrads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        return real_add()

    step.accumulator.add = add
    for i, (b, k) in enumerate(zip(batches, keys)):
        metrics = {n: float(v) for n, v in step(b, noise=jax_training_noise(cfg, b, k)).items()}
        assert ("grad_norm" in metrics) == (i == 1)
        for n, v in jmetrics[i].items():
            if n != "grad_norm":
                assert abs(metrics[n] - v) <= 1e-5 * max(abs(v), 1.0), (i, n, metrics[n], v)
        assert_grads_match(dict(port_grads=pgrads[i], jax_grads=jgrads[i]))
        if i == 0:  # MultiSteps leaves the parameters as they were on the first call, and so does the port
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), start[n]), n
            assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
                jax.tree_util.tree_leaves(params1), jax.tree_util.tree_leaves(params0)))
    assert schedule.last_epoch == 1 and step.accumulator.mini_step == 0

    # the port's update against optax's MultiSteps chain on the port's own gradients, carried back into the flax
    # tree by the inverse of `params_from_jax`'s rules (a Dense kernel transposed)
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(params0)

    def as_tree(by_name):
        leaves = []
        for path, _ in paths_leaves:
            keys = [k.key for k in path]
            if keys[-1] in ("kernel", "scale"):
                v = by_name[".".join(keys[:-1]) + ".weight"].numpy()
                leaves.append(jnp.asarray(v.T if keys[-1] == "kernel" else v))
            else:
                leaves.append(jnp.asarray(by_name[".".join(keys)].numpy()))
        return jax.tree_util.tree_unflatten(treedef, leaves)

    state, params = tx.init(params0), params0
    for g in pgrads:
        upd, state = tx.update(as_tree(g), state, params)
        params = optax.apply_updates(params, upd)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(t2n(p), want[n].numpy(), rtol=1e-6, atol=1e-9, err_msg=n)
    # and JAX's own update on its own gradients lands within Adam's step of the port's
    got2 = params_from_jax(jax.tree_util.tree_map(np.asarray, params2))
    assert max(float((p.detach() - got2[n]).abs().max()) for n, p in model.named_parameters()) <= \
        2 * cfg.optimizer.lr


# -- the entry point on the CPU -------------------------------------------------------------------------------------
def _fit_args(ckpt_dir, *extra):
    return ["action=fit", "device=cpu", "preset=tiny", "data=synthetic", f"ckpt_dir={ckpt_dir}", "log_every=100",
            "validate_every_epoch=false", *extra]


def test_fit_takes_the_steps_make_train_step_takes_by_hand(tmp_path):
    """Three steps with EMA and SWA through `run.fit` and by hand: parameters, EMA and SWA bit for bit."""
    cfg = dataclasses.replace(port_config.tiny_config(), ema_decay=0.5, swa=True, swa_epoch_start=0.0,
                              validate_every_epoch=False)
    train_loader, val_loader = run.make_dataloaders(cfg, "synthetic", None)
    model, _, stopped = run.fit(cfg, train_loader, val_loader, ckpt_dir=str(tmp_path), max_steps=3, device="cpu")
    assert not stopped and signal.getsignal(signal.SIGTERM) == signal.SIG_DFL  # handlers restored
    saved, _, meta = CheckpointManager(str(tmp_path)).restore("last")
    assert meta == {"step": 3, "epoch": 0}

    by_hand = build_model(cfg, device="cpu")
    names, params = zip(*by_hand.named_parameters())
    steps_per_epoch = max(int(len(train_loader) * cfg.limit_train_batches), 1)
    opt, schedule = make_optimizer(cfg.optimizer, by_hand.named_parameters(), steps_per_epoch=steps_per_epoch)
    step = make_train_step(cfg, by_hand, opt, schedule, device="cpu")
    ema, swa_state = swa.ema_init(params), swa.swa_init(params)
    for i, batch in zip(range(3), train_loader):
        step(batch, run.step_generator(cfg.seed + 1, i), 0)
        swa.ema_update(ema, params, 0.5)
        swa.swa_update(swa_state, params, i, 0)
    for n, p in by_hand.named_parameters():
        assert torch.equal(dict(model.named_parameters())[n].detach(), p.detach()), n
        assert torch.equal(saved["model"][n], p.detach()), n
    for n, e, s in zip(names, ema, swa.swa_params(swa_state, params)):
        assert torch.equal(saved["ema"][n], e) and torch.equal(saved["swa"][n], s), n
    assert not all(torch.equal(saved["swa"][n], saved["model"][n]) for n in names)
    assert not all(torch.equal(saved["ema"][n], saved["model"][n]) for n in names)


def _tensors_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("k,first", [(1, 2), (2, 3)])
def test_resumed_fit_ends_where_an_uninterrupted_one_does(tmp_path, k, first):
    """fit 4 against fit `first` + resume=true to 4, with EMA and SWA (and, at k=2, a half-accumulated gradient in
    the checkpoint): every entry of "last" bit for bit."""
    extra = ["ema_decay=0.5", "swa=true", "swa_epoch_start=0", f"optimizer.accumulate_grad_batches={k}"]
    run.main(_fit_args(tmp_path / "straight", "max_steps=4", *extra))
    run.main(_fit_args(tmp_path / "resumed", f"max_steps={first}", *extra))
    mid, _, mid_meta = CheckpointManager(str(tmp_path / "resumed")).restore("last")
    assert mid_meta["step"] == first and ("accumulator" in mid) == (k > 1)
    if k > 1:
        assert mid["accumulator"]["mini_step"] == first % k
    run.main(_fit_args(tmp_path / "resumed", "max_steps=4", "resume=true"))
    straight, _, meta = CheckpointManager(str(tmp_path / "straight")).restore("last")
    resumed, cfg, meta2 = CheckpointManager(str(tmp_path / "resumed")).restore("last")
    assert meta == meta2 == {"step": 4, "epoch": 0}
    assert cfg.ema_decay == 0.5 and cfg.optimizer.accumulate_grad_batches == k  # the config came from the checkpoint
    assert set(straight) == set(resumed) >= {"model", "optimizer", "schedule", "ema", "swa", "swa_state"}
    for entry in straight:
        assert _tensors_equal(straight[entry], resumed[entry]), entry
    assert not _tensors_equal(mid["model"], resumed["model"])


def test_sigterm_exits_143_and_a_resume_adds_one_step(tmp_path):
    args = [sys.executable, "-u", "-m", "trafficbotsv15_tpu_torch.run", *_fit_args(tmp_path, "max_epochs=5"),
            "log_every=1"]
    proc = subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("[step 1]"):  # the handler is installed before the first step
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 143, out[-2000:]
    _, _, meta = CheckpointManager(str(tmp_path)).restore("last")
    assert 1 <= meta["step"] < 5 * 6
    resumed = subprocess.run(args + ["resume=true", f"max_steps={meta['step'] + 1}"], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert CheckpointManager(str(tmp_path)).restore("last")[2]["step"] == meta["step"] + 1


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Two steps and one validation of 16 scenarios: "last" and "best" at step 2."""
    ckpt_dir = tmp_path_factory.mktemp("fitted")
    run.main(["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={ckpt_dir}", "max_steps=2", "val_epoch_batches=1",
              "batch_size_test=16"])
    return ckpt_dir


def test_validate_action_runs_from_last(fitted):
    metrics = run.main(["action=validate", "device=cpu", "preset=tiny", f"ckpt_dir={fitted}", "batch_size_test=16"])
    best = json.loads((fitted / "best.json").read_text())["meta"]
    assert best["step"] == 2 and metrics["val/loss"] == best["score"]  # the same parameters, batch and draws


def test_test_action_runs_from_best_at_k128(fitted, monkeypatch):
    """From "best" at K=128: without `waymo_open_dataset` the arrays come back; with its structural stub
    (`tests/waymo_stub`) the WOMD and WOSAC submissions are written into ckpt_dir, nowhere else."""
    import waymo_stub
    from trafficbotsv15_tpu_torch.eval import submission

    calls = []
    real = port_eval.joint_future_pred
    monkeypatch.setattr(port_eval, "joint_future_pred",
                        lambda *a, **kw: calls.append(kw["n_joint_future"]) or real(*a, **kw))

    def no_waymo(*args, **kwargs):
        raise ImportError("no waymo_open_dataset")

    args = ["action=test", "device=cpu", "preset=tiny", f"ckpt_dir={fitted}", "batch_size_test=4"]
    with monkeypatch.context() as mp:
        mp.setattr(submission, "SubWOMD", no_waymo)
        result = run.main(args)
    cfg = port_config.tiny_config()
    n_fut = cfg.time_step_gt - cfg.time_step_current
    assert calls == [128] * 4 and len(result) == 4
    for out in result:
        assert out["wosac_trajs"].shape == (4, 32, cfg.data.n_ag, n_fut, 3) and np.isfinite(out["wosac_trajs"]).all()
        assert out["womd_trajs"].shape == (4, cfg.data.n_ag, 6, n_fut // 5, 3)

    waymo_stub.install()
    paths = run.main(args)
    assert len(paths) == 2 and all(Path(p).exists() and Path(p).resolve().is_relative_to(fitted.resolve())
                                   for p in paths), paths


@pytest.mark.parametrize("arg,names", [("parallel.strategy=zero", "unknown parallel.strategy"),
                                       ("parallel.model_axis=0", "at least 1"), ("rbg=true", "JAX")])
def test_keys_without_a_counterpart_raise(tmp_path, arg, names):
    """JAX's PRNG switch has no counterpart (NotImplementedError); a strategy neither package knows and a model axis
    under 1 are refused (ValueError)."""
    with pytest.raises(NotImplementedError if arg.startswith("rbg") else ValueError, match=names):
        run.main(["action=fit", "device=cpu", "preset=tiny", f"ckpt_dir={tmp_path}", "max_steps=1", arg])
    assert not (tmp_path / "last").exists()


def test_no_module_of_the_port_imports_jax_or_its_libraries():
    """The port's modules (those of this slice included) and chip_smoke.py import none of jax, flax, optax, orbax
    or the JAX package, and loading every module pulls none of them in."""
    import re

    port = REPO / "trafficbotsv15_tpu_torch"
    sources = sorted(port.rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(p.relative_to(REPO)) for p in sources}
    assert names >= {f"trafficbotsv15_tpu_torch/{m}.py" for m in (
        "run", "train/checkpoint", "train/swa", "train/optimizer", "data/h5_dataset", "data/tbcache",
        "sim/teacher_forcing")}
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|optax|orbax|trafficbotsv15_tpu)\b", re.M)
    assert not [n for n, p in zip(sorted(names), sources) if pat.search(p.read_text())]
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__") for p in port.rglob("*.py")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', "
              "'trafficbotsv15_tpu')]\nassert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
