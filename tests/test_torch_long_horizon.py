"""PyTorch port: rollouts past the ground truth's horizon, against the JAX package on the CPU.

`tiny_config()` with `time_step_end` 30 against 21 logged steps (`time_step_gt` 20), the regime of the
scaled preset (120 rollout steps against 91 logged): past the log the TL subsystem runs from its own
predictions (the port's `sim/tl_prepass.py::tl_rollout_scan`, JAX's in-scan TL path), nothing is forced,
reset or rewarded, and the TL-state NLL is masked off. Random weights at gain 0.5 (`test_torch_slice.py`
says why), two synthetic scenarios, the KNN on the stable sort in both. Compared, at the existing tests'
tolerances:
  - `joint_future_pred` (check_level=1, K=2, K0 deterministic): the K0 rows and rule flags, and every row
    of the rollout with the JAX draws injected (`test_torch_slice.py`'s: 1e-3 on poses, motion and actions,
    1e-4 on log probabilities, validity, forcing, TL states and flags exact);
  - one training step with every dropout rate at 0 and the JAX draws injected, against
    `jax.jit(jax.value_and_grad(training_forward))`, which takes JAX's in-scan TL path
    (`test_torch_train_grad.py`'s: the loss terms and grad_norm to 1e-5 relative, every parameter's
    gradient to 1e-4 of its largest plus 1e-7); at tiny widths with the error-threshold reset on, and at
    the scaled preset's widths (d_model 256, 8 heads, latent 32) with tiny's 1-2 layers per encoder, there
    with the one map-encoder FFN unit whose ReLU input sits at float32 rounding moved off it in both;
  - reactive replay (its buffer, its loss) and the whole validation step, from JAX's jitted
    `make_validate_step` with its joint-future draws injected (`test_torch_validate.py`'s: 1e-3 on poses
    and trajectories, 1e-4 on log probabilities and scores, 1e-4 relative on loss terms, sums and
    realism, flags and counts exact). Past the horizon JAX's step raises in two places,
    `error_metric_sums` and `realism_from_rollout` (the buffer and the log do not broadcast); the port's
    score the logged steps only, so the JAX step runs with those two handed the buffer cut to them;
  - the TL pass with a forcing mask that is not all true inside the horizon: no config of the JAX package
    makes one (`build_forcing_masks` hands the all-true TL mask back), so the port's `tl_rollout_scan` is
    held against JAX's on a random mask (`test_torch_models.py`'s 2e-4 on encoder outputs, states exact),
    and, forced everywhere inside the log, against JAX's batched pre-pass (`tl_rollout_forced`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_grads_match, assert_loss_matches, jax_model_params, jax_sort_knn,
                                no_dropout, port_cfg, port_model, set_threads, t2n, to_jnp, train_step_parity)
from test_torch_slice import K0_FIELDS, ROW_FIELDS, _assert_flags, _assert_rows, _inject, _run_both
from test_torch_validate import JF_SAMPLES, LOGP_ATOL, POSE_ATOL, REL, _assert_buffers, _assert_losses, _close
from trafficbotsv15_tpu.config import scaled_config, tiny_config
from trafficbotsv15_tpu.data.preprocessing import pre_processing as jax_pre
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu.eval import runner as jax_runner
from trafficbotsv15_tpu.eval import wosac_likelihood as jax_wosac_likelihood
from trafficbotsv15_tpu.sim import rollout as jax_rollout_lib
from trafficbotsv15_tpu.sim import tl_prepass as jax_tl_prepass
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing as port_pre
from trafficbotsv15_tpu_torch.eval import runner as port_runner
from trafficbotsv15_tpu_torch.sim import tl_prepass
from trafficbotsv15_tpu_torch.train import evaluation as port_eval
from trafficbotsv15_tpu_torch.train import pipeline as port_pipeline

set_threads()
N_END = 30  # rollout steps; the synthetic log holds 21 (steps 0..20)


def _long(cfg):
    """cfg (either package's) rolled out to N_END steps, past its 21 logged ones."""
    assert cfg.time_step_end + 10 <= N_END
    return dataclasses.replace(cfg, time_step_end=N_END)


def _scaled_widths():
    """The scaled preset's widths (hidden 256, 8 heads, latent 32) at tiny_config's depth and data."""
    tiny, scaled = tiny_config(), scaled_config().model
    m = tiny.model
    return dataclasses.replace(tiny, model=dataclasses.replace(
        m, hidden_dim=scaled.hidden_dim,
        tf_cfg=dataclasses.replace(m.tf_cfg, d_model=scaled.tf_cfg.d_model, n_head=scaled.tf_cfg.n_head),
        latent_encoder=dataclasses.replace(m.latent_encoder, latent_dim=scaled.latent_encoder.latent_dim)))


# ---------------------------------------------------------------------------------------------- joint futures

@pytest.fixture(scope="module")
def jf_run():
    return _run_both(_long(dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)),
                     check_level=1)


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_joint_future_pred_k0_rows_past_the_horizon(jf_run, field, atol):
    _assert_rows(jf_run["jbuf"], jf_run["pbuf"], field, atol, k0_only=True)


def test_joint_future_pred_k0_rule_flags_past_the_horizon(jf_run):
    _assert_flags(jf_run["jbuf"], jf_run["pbuf"], k0_only=True)


def test_joint_future_pred_free_runs_past_the_history(jf_run):
    """N_END steps of finite poses; from the first step the history does not cover (the joint futures' TL log)
    on, no teacher forcing and the TL-state NLL masked off, the TL state the argmax of its own logits."""
    buf, cfg = jf_run["pbuf"], jf_run["cfg"]
    assert buf.pred_pose.shape[3] == N_END and torch.isfinite(buf.pred_pose).all()
    free = cfg.n_step_hist - 1  # buffer index of the first step past the history
    assert buf.tl_state_nll_invalid[..., free:].all() and not buf.tl_state_nll_invalid[..., :free].all()
    assert not buf.mask_teacher_forcing[..., free:].any()


@pytest.fixture(scope="module")
def jf_injected(jf_run):
    return _inject(jf_run)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_rollout_with_injected_samples_every_row_past_the_horizon(jf_injected, field, atol):
    _assert_rows(*jf_injected, field, atol)


# ---------------------------------------------------------------------------------------------- training

def _relu_margins(cfg, tree):
    """{layer: (unit, min |x| / mean |x|)} of the ReLU inputs (each FFN's first projection) of every map-encoder
    layer, in the port's forward on the training step's batch (its history dropout included)."""
    from test_torch_helpers import jax_training_noise

    model = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    noise = jax_training_noise(cfg, batch, jax.random.PRNGKey(3))
    ppp = port_pre({k: torch.from_numpy(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True,
                   dropout_p_history=cfg.dropout_p_history, u_mp=noise["u_mp"], u_ag=noise["u_ag"])
    layers = {n: m for n, m in model.named_modules() if n.startswith("mp_encoder.") and n.endswith(".ffn1")}
    acts = {}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: acts.update({n: o.detach().abs()}))
             for n, m in layers.items()]
    try:
        with torch.no_grad():
            model.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
    finally:
        for hook in hooks:
            hook.remove()
    assert set(acts) == set(layers) and acts
    return {n: (int(x.flatten(0, -2).min(0).values.argmin()), float(x.min() / x.mean())) for n, x in acts.items()}


KINK_MARGIN = 1e-6  # a ReLU input this close to 0, relative to its layer's mean |input|: rounding decides its sign
KINK_NUDGE = -0.01  # the bias step that takes such a unit off the kink (its layer's mean |input| is ~0.3)


def _off_the_kink(cfg):
    """edit_tree for train_step_parity: every map-encoder FFN unit whose ReLU input sits within KINK_MARGIN of 0
    gets KINK_NUDGE on its bias, the same weights in both packages."""
    def edit(tree):
        for name, (unit, margin) in _relu_margins(cfg, tree).items():
            if margin < KINK_MARGIN:
                leaf = tree
                for part in name.split("."):
                    leaf = leaf[part]
                bias = np.array(leaf["bias"])
                bias[unit] += KINK_NUDGE
                leaf["bias"] = bias
        return tree
    return edit


# the error-threshold reset on in training (test_torch_run.py's thresholds): it fires inside the log and JAX's
# `gt_avail` gates it off past it, where the log's padding is zeros
RESET = dict(threshold_xy=0.3, threshold_yaw=5.0, threshold_spd=0.5)


@pytest.fixture(scope="module", params=["tiny_error_reset", "scaled_widths"])
def train_run(request):
    if request.param == "tiny_error_reset":
        cfg = _long(tiny_config())
        cfg = dataclasses.replace(cfg, teacher_forcing_training=dataclasses.replace(cfg.teacher_forcing_training,
                                                                                    **RESET))
        return train_step_parity(no_dropout(cfg))
    cfg = no_dropout(_long(_scaled_widths()))
    return train_step_parity(cfg, edit_tree=_off_the_kink(cfg))


def test_train_step_loss_and_grad_norm_match_jax_past_the_horizon(train_run):
    assert_loss_matches(train_run)


def test_train_step_every_parameter_gradient_matches_jax_past_the_horizon(train_run):
    """Every parameter, at tiny widths and at the scaled preset's (there with one map-encoder FFN unit taken off
    its ReLU kink, test_scaled_widths_map_encoder_has_a_relu_input_at_rounding_level says why)."""
    assert_grads_match(train_run)


def test_scaled_widths_map_encoder_backward_matches_jax():
    """The map encoder's parameter gradients at the scaled preset's widths, its weights as drawn, for a random
    cotangent at its output, on the pre-processed batch without history dropout (2e-4 absolute on O(1) outputs,
    test_torch_models.py's tolerance for whole encoders, applied to gradients relative to their largest)."""
    from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

    cfg = _long(_scaled_widths())
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    pmodel = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    jpp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist)
    ppp = port_pre({k: torch.from_numpy(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist)
    ct = np.random.default_rng(0).standard_normal((2, cfg.data.n_mp, cfg.model.hidden_dim)).astype(np.float32)

    def f(p):
        tokens = jmodel.apply({"params": p}, jpp.mp_valid, jpp.mp_attr, jpp.mp_pose, jpp.mp_type, method="encode_map")
        return jnp.sum(tokens.feature * ct)

    with jax_sort_knn():
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(f))(to_jnp(tree))))
    tokens = pmodel.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
    (tokens.feature * torch.from_numpy(ct)).sum().backward()
    names = [n for n, _ in pmodel.named_parameters() if n.startswith("mp_encoder.")]
    assert names
    for n, p in pmodel.named_parameters():
        if n in names:
            assert float((p.grad - want[n]).abs().max()) <= 2e-4 * float(want[n].abs().max()), n


def test_scaled_widths_map_encoder_has_a_relu_input_at_rounding_level():
    """Why the scaled-widths training step runs with one bias nudged: with the weights as drawn, one FFN unit of the
    map encoder's first layer sees a ReLU input within KINK_MARGIN of zero on one token, relative to the layer's
    mean |input|, so float32 rounding decides whether that unit passes gradient, and the two packages' gradients
    below it differ by up to 7e-3 of their scale. KINK_NUDGE on that unit's bias, in both packages alike, takes it
    off the kink and leaves no map-encoder ReLU input within KINK_MARGIN of zero; the step's every gradient then
    matches JAX's at the stated tolerance (the tests above)."""
    cfg = no_dropout(_long(_scaled_widths()))
    _, tree = jax_model_params(cfg, seed=0, gain=0.5)
    before = _relu_margins(cfg, tree)
    kinked = [n for n, (_, margin) in before.items() if margin < KINK_MARGIN]
    assert kinked == ["mp_encoder.tf_mp2mp.layer0.ffn1"], before
    after = _relu_margins(cfg, _off_the_kink(cfg)(tree))
    assert min(margin for _, margin in after.values()) > KINK_MARGIN, after


def test_tl_rollout_scan_fully_forced_matches_jax_pre_pass():
    """With TL forced over a logged horizon, the port's step-by-step TL pass gives what JAX's batched pre-pass
    (`tl_rollout_forced`, JAX training's path there) gives: every window a GT slice (test_torch_models.py's 2e-4
    on encoder outputs, states exact)."""
    cfg = tiny_config()
    n, w = cfg.time_step_end, cfg.model.temp_window_size
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    pmodel = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    jpp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True)
    ppp = port_pre({k: torch.from_numpy(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True)
    assert jpp.gt_tl_state.shape[2] >= n + 1
    params = to_jnp(tree)

    def app(*a, method):
        return jmodel.apply({"params": params}, *a, method=method)

    with jax_sort_knn(), torch.no_grad():
        jmp = app(jpp.mp_valid, jpp.mp_attr, jpp.mp_pose, jpp.mp_type, method="encode_map")
        jtl = app(jpp.tl_valid, jpp.tl_attr, jpp.tl_pose, jmp, method="precompute_tl")
        want = jax_tl_prepass.tl_rollout_forced(jmodel, params, jtl, jpp.gt_tl_state.astype(jnp.float32), n, w)
        pmp = pmodel.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
        ptl = pmodel.precompute_tl(ppp.tl_valid, ppp.tl_attr, ppp.tl_pose, pmp)
        gt = ppp.gt_tl_state.float()
        got = tl_prepass.tl_rollout_scan(pmodel, ptl, gt, torch.ones(gt.shape[:3], dtype=torch.bool), n, w)
    for key, atol in (("feature", 2e-4), ("logits", 2e-4), ("state", 0)):
        np.testing.assert_allclose(t2n(got[key]), np.asarray(want[key], np.float32), rtol=0, atol=atol, err_msg=key)
    assert torch.equal(got["state"], gt[:, :, 1:n + 1].movedim(2, 0))


@pytest.mark.parametrize("time_step_end", [20, N_END])
def test_training_forward_runs_the_tl_pass_with_a_seed_per_step(monkeypatch, time_step_end):
    """training_forward runs `tl_rollout_scan` once, inside the log and past it, with one dropout seed per rollout
    step; the noise has N steps' seeds."""
    cfg = port_cfg(dataclasses.replace(tiny_config(), time_step_end=time_step_end))
    model = port_pipeline.build_model(cfg, seed=0, device="cpu")
    batch = port_eval.batch_to_device(make_batch(cfg.data, n_sc=1, seed=1), torch.device("cpu"))
    noise = port_pipeline.draw_training_noise(cfg, batch, torch.Generator().manual_seed(0), "cpu")
    assert len(noise["seeds_tl"]) == len(noise["seeds_step"]) == time_step_end
    calls, real = [], tl_prepass.tl_rollout_scan
    monkeypatch.setattr(tl_prepass, "tl_rollout_scan", lambda *a, **kw: calls.append(kw["seeds"]) or real(*a, **kw))
    loss, _ = port_pipeline.training_forward(cfg, model, batch, noise)
    assert calls == [noise["seeds_tl"]]
    assert torch.isfinite(loss)


def test_error_reset_fires_inside_the_log_only(monkeypatch):
    """With RESET set, training's rollout forces agents back to the log at steps the forcing mask leaves free,
    and at none past the log's last step (the parity above is then not vacuous)."""
    from trafficbotsv15_tpu_torch.sim import rollout as port_rollout

    cfg = port_cfg(_long(tiny_config()))
    cfg = dataclasses.replace(cfg, teacher_forcing_training=dataclasses.replace(cfg.teacher_forcing_training, **RESET))
    model = port_pipeline.build_model(cfg, seed=0, device="cpu")
    batch = port_eval.batch_to_device(make_batch(cfg.data, n_sc=2, seed=1), torch.device("cpu"))
    noise = port_pipeline.draw_training_noise(cfg, batch, torch.Generator().manual_seed(0), "cpu")
    seen, real = {}, port_rollout.rollout_train

    def rollout_train(*args, **kwargs):
        seen.update(kwargs, buf=real(*args, **kwargs))
        return seen["buf"]

    monkeypatch.setattr(port_rollout, "rollout_train", rollout_train)
    with torch.no_grad():
        port_pipeline.training_forward(cfg, model, batch, noise)
    forced, mask = seen["buf"].mask_teacher_forcing, tl_prepass.pad_steps(seen["ag_forcing"], N_END, False)
    past = cfg.data.n_step - 1
    assert (forced & ~mask)[..., :past].any()
    assert not forced[..., past:].any()


# ---------------------------------------------------------------------------------------------- validation

def _cut_to_log(buf, n_step: int):
    """A flattened JAX buffer [n_sc, K, n, n_step, ...] cut to its first n_step steps."""
    return jax.tree_util.tree_map(lambda x: x[:, :, :, :n_step] if x.ndim >= 4 else x, buf)


@pytest.fixture(scope="module")
def validate_run():
    """JAX's jitted validation step (its error sums and realism handed the buffers cut to the logged steps),
    its reactive-replay buffer and joint-future draws; the port's step on the same batch with those draws."""
    cfg = _long(tiny_config())
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    n_logged = cfg.data.n_step - 1  # buffer steps 1..20 have a log
    jstep = jax_runner.make_validate_step(cfg, jmodel)
    real_err, real_realism = jax_runner.error_metric_sums, jax_wosac_likelihood.realism_from_rollout
    real_rollout, real_log_prob = jax_rollout_lib.rollout, jax_rollout_lib.compute_log_prob

    def step_and_draws(params, b, key):
        rollouts, log_probs = [], []

        def rollout(*args, **kwargs):
            buf = real_rollout(*args, **kwargs)
            rollouts.append(({k: kwargs[k] for k in JF_SAMPLES}, buf))
            return buf

        def compute_log_prob(buf, latent_log_prob):
            log_probs.append(latent_log_prob)
            return real_log_prob(buf, latent_log_prob)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rollout_lib, "rollout", rollout)
            mp.setattr(jax_rollout_lib, "compute_log_prob", compute_log_prob)
            mp.setattr(jax_runner, "error_metric_sums", lambda buf, *a: real_err(_cut_to_log(buf, n_logged), *a))
            mp.setattr(jax_wosac_likelihood, "realism_from_rollout",
                       lambda b_, pp, buf, step: real_realism(b_, pp, _cut_to_log(buf, n_logged), step))
            out = jstep(params, b, key)
        assert len(rollouts) == 2 and len(log_probs) == 1  # reactive replay, then the joint futures
        return out, dict(rollouts[1][0], latent_log_prob=log_probs[0]), rollouts[0][1]

    with jax_sort_knn():
        jout, draws, rr_buffer = jax.jit(step_and_draws)(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()},
                                                         jax.random.PRNGKey(0))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    pcfg, pmodel = port_cfg(cfg), port_model(cfg, tree)
    seen = {}
    real_rr = port_eval.reactive_replay

    def rr(*args, **kwargs):
        seen["rr"] = real_rr(*args, **kwargs)
        return seen["rr"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_eval, "sample_joint_futures", lambda *a, **kw: dict(draws))
        mp.setattr(port_eval, "reactive_replay", rr)
        pout = port_runner.make_validate_step(pcfg, pmodel, device="cpu")(batch, torch.Generator().manual_seed(0))
    return dict(cfg=pcfg, jout=jout, pout=pout, jrr=rr_buffer, prr=seen["rr"])


def test_reactive_replay_buffer_matches_jax_past_the_horizon(validate_run):
    pbuf, cfg = validate_run["prr"][1], validate_run["cfg"]
    assert tuple(pbuf.pred_pose.shape) == (2, cfg.data.n_ag, N_END, 3)
    _assert_buffers(validate_run["jrr"], pbuf)
    past = cfg.data.n_step - 1  # buffer index of the first step past the log
    assert pbuf.tl_state_nll_invalid[..., past:].all() and not pbuf.mask_teacher_forcing[..., past:].any()
    assert not pbuf.diffbar_reward["diffbar_reward_valid"][..., past:].any()


def test_reactive_replay_loss_matches_jax_past_the_horizon(validate_run):
    _assert_losses(validate_run["pout"]["loss_metrics"], validate_run["jout"]["loss_metrics"])


def test_validate_step_out_keys_past_the_horizon(validate_run):
    assert set(validate_run["pout"]) == set(validate_run["jout"])
    assert {"wosac_realism", "womd_metric_vals", "womd_rr_metric_vals"} <= set(validate_run["pout"])


@pytest.mark.parametrize("entry", ["err_sums", "rr_rule", "jf_rule", "womd_metric_vals", "womd_rr_metric_vals",
                                   "wosac_realism"])
def test_validate_step_sums_and_metrics_match_jax_past_the_horizon(validate_run, entry):
    got, want = validate_run["pout"][entry], validate_run["jout"][entry]
    assert set(got) == set(want)
    for key, val in want.items():
        if entry in ("rr_rule", "jf_rule") or "miss_rate" in key:  # counts and rates of counts
            _close(got[key], val, msg=key)
        elif entry.startswith("womd"):  # means of distances
            _close(got[key], val, atol=POSE_ATOL, msg=key)
        else:
            _close(got[key], val, atol=1e-6, rtol=REL, msg=key)


@pytest.mark.parametrize("entry,atol", [("womd_trajs", POSE_ATOL), ("womd_scores", LOGP_ATOL),
                                        ("wosac_trajs", POSE_ATOL), ("womd_rr_trajs", POSE_ATOL),
                                        ("womd_rr_scores", LOGP_ATOL)])
def test_validate_step_trajectories_match_jax_past_the_horizon(validate_run, entry, atol):
    """WOMD's modes are cut to the logged future as JAX cuts them; the WOSAC futures run to N_END, as JAX's."""
    _close(validate_run["pout"][entry], validate_run["jout"][entry], atol=atol, msg=entry)


def test_error_sums_count_the_logged_steps_only(validate_run):
    """Past the horizon the error sums count the agent-steps that have a log: those of the buffer cut to it."""
    from trafficbotsv15_tpu_torch.eval.metrics import error_metric_sums

    pp, buf = validate_run["prr"][:2]
    flat = buf.flatten_joint_future(1)
    cut = dataclasses.replace(flat, pred_valid=flat.pred_valid[..., :20], pred_pose=flat.pred_pose[..., :20, :],
                              pred_motion=flat.pred_motion[..., :20, :])
    got, want = (error_metric_sums(b, pp.gt_valid, pp.gt_pose, pp.gt_motion) for b in (flat, cut))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    assert float(got["err_counter"]) > 0


# ---------------------------------------------------------------------------------------------- the TL pass

def test_tl_rollout_scan_with_partial_forcing_matches_jax():
    """TL forced on a random half of the (lane, step) entries inside the log, N_END steps past it."""
    cfg = _long(tiny_config())
    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    pmodel = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    jpp = jax_pre({k: jnp.asarray(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True)
    ppp = port_pre({k: torch.from_numpy(v) for k, v in batch.items()}, n_step_hist=cfg.n_step_hist, training=True)
    forcing = np.random.default_rng(0).uniform(size=jpp.gt_tl_state.shape[:3]) < 0.5
    w = cfg.model.temp_window_size
    params = to_jnp(tree)

    def app(*a, method):
        return jmodel.apply({"params": params}, *a, method=method)

    with jax_sort_knn(), torch.no_grad():
        jmp = app(jpp.mp_valid, jpp.mp_attr, jpp.mp_pose, jpp.mp_type, method="encode_map")
        jtl = app(jpp.tl_valid, jpp.tl_attr, jpp.tl_pose, jmp, method="precompute_tl")
        want = jax_tl_prepass.tl_rollout_scan(jmodel, params, jtl, jpp.gt_tl_state.astype(jnp.float32),
                                              jnp.asarray(forcing), N_END, w)
        pmp = pmodel.encode_map(ppp.mp_valid, ppp.mp_attr, ppp.mp_pose, ppp.mp_type)
        ptl = pmodel.precompute_tl(ppp.tl_valid, ppp.tl_attr, ppp.tl_pose, pmp)
        gt = ppp.gt_tl_state.float()
        got = tl_prepass.tl_rollout_scan(pmodel, ptl, gt, torch.from_numpy(forcing), N_END, w)
    for key, atol in (("feature", 2e-4), ("logits", 2e-4), ("state", 0)):
        np.testing.assert_allclose(t2n(got[key]), np.asarray(want[key], np.float32), rtol=0, atol=atol, err_msg=key)
    # the mask mattered: inside the log some forced states differ from what the model predicts
    free = tl_prepass.tl_rollout_scan(pmodel, ptl, gt, torch.zeros_like(torch.from_numpy(forcing)), N_END, w)
    assert not torch.equal(free["state"], got["state"])
