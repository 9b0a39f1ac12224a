"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are random, made from a seed with numpy in the shapes of the JAX
package's param tree (`jax.eval_shape` of its `init_params`, no compute),
and handed to both packages: JAX applies the tree, the port loads it through
`utils/jax_import.py`. Both run on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trafficbotsv15_tpu.ops import flags as jax_flags
from trafficbotsv15_tpu.ops.flags import OpsCfg as JaxOpsCfg
from trafficbotsv15_tpu_torch.sim.rollout import repredicts  # reads either package's config

TORCH_THREADS = 2  # tier-1 runs several pytest workers side by side


def set_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


@contextlib.contextmanager
def jax_sort_knn():
    """JAX's KNN on the stable sort (the port's only selection), restored after."""
    prev = jax_flags._configured
    jax_flags.configure(JaxOpsCfg(knn_impl="sort"))
    try:
        yield
    finally:
        jax_flags.configure(prev)


def random_tree(shapes, seed: int, gain: float = 1.0):
    """Numpy params in the shapes of a flax tree of ShapeDtypeStructs; matrices
    are normal with std gain / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        if len(shape) == 2:  # Dense kernel, kv_w, rpe_proj_w: [in, out]
            return (gain * rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        if name in ("scale", "norm_tgt_scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.startswith("log_std"):
            return (-2.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_model_params(cfg, seed: int = 0, gain: float = 1.0):
    """(flax TrafficBots, numpy param tree) for cfg, from param shapes only."""
    from trafficbotsv15_tpu.data.synthetic import make_batch
    from trafficbotsv15_tpu.train.pipeline import build_model, init_params

    model = build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg.data, n_sc=1, seed=0).items()}
    shapes = jax.eval_shape(lambda: init_params(cfg, model, batch, jax.random.PRNGKey(0)))
    return model, random_tree(shapes, seed, gain)


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_model(cfg, tree):
    """The port's TrafficBots on the CPU with the tree's weights (every leaf carried, or it raises)."""
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params

    model = build_model(port_cfg(cfg), device="cpu")
    load_jax_params(model, tree)
    return model


def port_cfg(jax_cfg):
    """The port's ExperimentCfg equal field by field to a JAX ExperimentCfg."""
    import dataclasses

    from trafficbotsv15_tpu_torch import config as pc

    def build(cls, d):
        default = cls()
        return cls(**{k: build(type(getattr(default, k)), v) if isinstance(v, dict) else v for k, v in d.items()})

    return build(pc.ExperimentCfg, dataclasses.asdict(jax_cfg))


def t2n(x):
    return x.detach().cpu().float().numpy() if x.dtype != torch.bool else x.detach().cpu().numpy()


def no_dropout(cfg):
    """cfg (either package's) with every dropout rate at 0: JAX keys and torch generators never
    draw the same masks, so parity runs without them (the port's dropout has its own tests)."""
    import dataclasses as dc

    m = cfg.model
    return dc.replace(cfg, model=dc.replace(
        m, tf_cfg=dc.replace(m.tf_cfg, dropout_p=0.0),
        mp_encoder=dc.replace(m.mp_encoder, pl_encoder=dc.replace(m.mp_encoder.pl_encoder, mlp_dropout_p=0.0)),
        add_navi_latent=dc.replace(m.add_navi_latent, mlp_dropout_p=0.0)))


def jax_navi_noise(cfg, key, n_sc: int, n_ag: int, n_mp: int):
    """The noise of the navi a JAX rollout keyed `key` re-predicts at each step (pred_navi_after_reached): step i
    splits its carry's key into (next, action, dropout, navi), and the navi key draws the goal's standard normal
    [n_sc, n_ag, 4] (`DiagGaussian.sample`) or the destination's Gumbel noise [n_sc, n_ag, n_mp]
    (`jax.random.categorical`), in float32. -> one torch tensor per rollout step."""
    noise = []
    for _ in range(cfg.time_step_end):
        key, _, _, k_navi = jax.random.split(key, 4)
        if cfg.model.navi_mode == "goal":
            x = jax.random.normal(k_navi, (n_sc, n_ag, 4), jnp.float32)
        else:
            x = jax.random.gumbel(k_navi, (n_sc, n_ag, n_mp), jnp.float32)
        noise.append(torch.from_numpy(np.array(x)))
    return noise


def jax_latent_noise(cfg, k_sample, n_sc: int, n_ag: int):
    """The noise of JAX `_select_latent`'s draws with k_sample (both from one key): the standard normal of a Gaussian
    latent [n_sc, n_ag, latent_dim], or the Gumbel noise [n_sc, n_ag, n_cat, latent_dim // n_cat] of a categorical
    one (`MultiCategorical.sample` is `jax.random.categorical`, argmax(logits + gumbel(key, logits.shape)))."""
    lat = cfg.model.latent_encoder
    if lat.latent_dim > 0 and lat.latent_post.dist_type in ("cat", "std_cat"):
        n_cat = lat.latent_post.n_cat
        return jax.random.gumbel(k_sample, (n_sc, n_ag, n_cat, lat.latent_dim // n_cat), jnp.float32)
    return jax.random.normal(k_sample, (n_sc, n_ag, max(lat.latent_dim, 1)))


def jax_training_noise(cfg, batch, key, n_seeds=None):
    """The JAX `training_forward(key)`'s own random draws, as the port's noise dict: the uniforms
    behind its Bernoulli masks (history dropout, prior choice, agent forcing, irrelevant-agent loss)
    and the latent noise (`jax_latent_noise`), from the same key splits, and with re-prediction the rollout's navi noise
    per step (`jax_navi_noise`). Dropout seeds are plain integers."""
    k_pre, k_latent, k_tf, k_roll, _, k_loss = jax.random.split(key, 6)
    n_sc, n_mp, n_node = batch["map/valid"].shape
    n_ag, n_step = batch["agent/valid"].shape[1:3]
    k1, k2 = jax.random.split(k_pre)
    k_sel, k_sample = jax.random.split(k_latent)
    kt1, kt2 = jax.random.split(k_tf)
    t = lambda x: torch.from_numpy(np.asarray(x))
    lm, tf = cfg.training_metrics, cfg.teacher_forcing_training
    n_roll = cfg.time_step_end if n_seeds is None else n_seeds
    extra = {"navi_noise": jax_navi_noise(cfg, k_roll, n_sc, n_ag, n_mp)} if repredicts(cfg) else {}
    return dict(
        **extra,
        u_mp=t(jax.random.uniform(k1, (n_sc, n_mp, n_node - 1))),
        u_ag=t(jax.random.uniform(k2, (n_sc, n_ag, cfg.n_step_hist - 1))),
        u_prior=t(jax.random.uniform(k_sel, ())),
        latent_eps=t(jax_latent_noise(cfg, k_sample, n_sc, n_ag)),
        u_agent=t(jax.random.uniform(kt1, (n_sc, n_ag))) if tf.prob_forcing_agent > 0 else None,
        u_ss=t(jax.random.uniform(kt2, (n_sc, n_ag, n_step))) if tf.prob_scheduled_sampling > 0 else None,
        u_irrelevant=t(jax.random.uniform(k_loss, (n_sc, n_ag, 1))) if 0 < lm.p_loss_for_irrelevant < 1 else None,
        seed_encoders=0, seeds_tl=list(range(1, n_roll + 1)), seeds_step=list(range(n_roll + 1, 2 * n_roll + 1)),
    )


# gradient parity of one training step (tests/test_torch_train_grad*.py): the port's gradient of
# each parameter against JAX's, |port - jax| <= GRAD_RTOL * max|jax| of that parameter + GRAD_ATOL.
# float32 through 20 BPTT steps, reduction order only: measured <= 5e-6 of the max and <= 5e-9
# absolute on parameters whose gradient is ~0.
GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-4, 1e-7, 1e-5


def train_step_parity(cfg, key_seed: int = 3, edit_tree=None, batch_seed: int = 1, to_port=None):
    """One training step of both packages on tiny-config weights (gain 0.5) and one batch, with the
    JAX draws handed to the port: JAX `jax.jit(jax.value_and_grad(training_forward))` and the port's
    `make_train_step` (its clip off and its optimizer replaced by a recorder of the gradients).
    edit_tree(tree) -> tree, if given, edits the random weights before both packages get them; batch_seed seeds the
    synthetic batch; to_port(tree) -> (port cfg, port model), if given, builds the port's side (by default
    `port_cfg(cfg)` and `port_model(cfg, tree)`).
    Returns dict(jax_loss, jax_metrics, jax_grads {port name: array}, port_metrics, port_grads, model)."""
    from trafficbotsv15_tpu.data.synthetic import make_batch
    from trafficbotsv15_tpu.train import pipeline as jax_pipeline
    from trafficbotsv15_tpu_torch.train import pipeline as port_pipeline
    from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

    jmodel, tree = jax_model_params(cfg, seed=0, gain=0.5)
    if edit_tree is not None:
        tree = edit_tree(tree)
    batch = make_batch(cfg.data, n_sc=2, seed=batch_seed)
    key = jax.random.PRNGKey(key_seed)

    def loss_fn(p, b):
        return jax_pipeline.training_forward(cfg, jmodel, p, b, key, 0)

    with jax_sort_knn():
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    pcfg, model = (port_cfg(cfg), port_model(cfg, tree)) if to_port is None else to_port(tree)
    recorded = {}

    class Recorder:  # the optimizer's stand-in; with the clip off it sees the raw gradients
        param_groups = [{"params": list(model.parameters())}]

        def step(self):
            recorded.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})

    pcfg = dataclasses.replace(pcfg, optimizer=dataclasses.replace(pcfg.optimizer, grad_clip_norm=math.inf))
    step = port_pipeline.make_train_step(pcfg, model, Recorder(), device="cpu")
    metrics = step(batch, noise=jax_training_noise(cfg, batch, key))
    return dict(jax_loss=float(jloss), jax_metrics={k: float(v) for k, v in jmetrics.items()}, jax_grads=jgrads,
                port_metrics={k: float(v) for k, v in metrics.items()}, port_grads=recorded, model=model)


def assert_grads_match(run) -> None:
    """Every parameter's gradient within the stated tolerance, and no parameter left out."""
    assert set(run["port_grads"]) == set(run["jax_grads"])
    bad = []
    for name, g in run["port_grads"].items():
        want = run["jax_grads"][name]
        err = float((g - want).abs().max())
        if err > GRAD_RTOL * float(want.abs().max()) + GRAD_ATOL:
            bad.append((name, err, float(want.abs().max())))
    assert not bad, bad[:10]


def assert_loss_matches(run) -> None:
    jm, pm = run["jax_metrics"], run["port_metrics"]
    assert set(jm) <= set(pm)
    for k, v in jm.items():
        assert abs(pm[k] - v) <= LOSS_RTOL * max(abs(v), 1.0), (k, pm[k], v)
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in run["jax_grads"].values())))
    assert abs(pm["grad_norm"] - gnorm) <= LOSS_RTOL * gnorm, (pm["grad_norm"], gnorm)


DETACH_FLAGS = ("training_detach_model_input", "detach_tl_feature", "dest_detach_mp_feature", "detach_input",
                "tl_lane_detach_mp_feature")


def flip_detach(cfg, flag: str):
    """cfg (either package's) with one of the switches that decide where gradients stop set to False."""
    import dataclasses as dc

    m = cfg.model
    if flag == "training_detach_model_input":
        return dc.replace(cfg, training_detach_model_input=False)
    sub = {"detach_tl_feature": "tl_state_predictor", "dest_detach_mp_feature": "navi_encoder",
           "detach_input": "navi_predictor", "tl_lane_detach_mp_feature": "tl_encoder"}[flag]
    return dc.replace(cfg, model=dc.replace(m, **{sub: dc.replace(getattr(m, sub), **{flag: False})}))


def port_grads(cfg, seed: int = 0, key_seed: int = 3):
    """The port's parameter gradients of one training forward (no optimizer), gain-0.5 weights."""
    from trafficbotsv15_tpu.data.synthetic import make_batch
    from trafficbotsv15_tpu_torch.train import pipeline as port_pipeline

    _, tree = jax_model_params(cfg, seed=seed, gain=0.5)
    model = port_model(cfg, tree)
    batch = make_batch(cfg.data, n_sc=2, seed=1)
    noise = jax_training_noise(cfg, batch, jax.random.PRNGKey(key_seed))
    loss, _ = port_pipeline.training_forward(port_cfg(cfg), model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                             noise)
    loss.backward()
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone() for n, p in model.named_parameters()}
