"""PyTorch port: the categorical CVAE latents against the JAX package, on the CPU.

`ops/distributions.py::MultiCategorical` against JAX's (logits [..., n_cat, n_class], draws flattened to
[..., n_cat * n_class]): probabilities and log-probs to 1e-6; draws with JAX's Gumbel noise injected
(`jax.random.categorical(key, logits)` is argmax(logits + jax.random.gumbel(key, logits.shape)), asserted here
first), deterministic and masked, equal; the straight-through gradient of a draw to 1e-6; `kl_multi_categorical`
and `balanced_kl` (alpha 0 and 0.2, free nats 0 and 0.5) and their gradients to 1e-6. The latent heads `cat`
(plain and type-branched) and `std_cat` with weights from `utils/jax_import.py::params_from_jax`: logits to 1e-5
(`tests/test_model_parity.py`'s `close`). A tie (std_cat's zero logits) draws the first class in both.
`joint_future_pred` with a `cat` posterior and prior and with a `std_cat` prior (`tests/torch_variant_common.py`):
the K0 rows (the prior's argmax one-hot) and every row with JAX's draws injected, at `tests/torch_rnn_common.py`'s
tolerances. The serving entry point with a `cat` prior: reset's latent rebuilt from the port's prior and JAX's
Gumbel noise equals JAX's; 6 steps with JAX's latent agree at `tests/test_torch_serve.py`'s tolerances.
The training step is `tests/test_torch_latent_cat_train.py`'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, random_tree, set_threads, t2n, \
    to_jnp
from torch_navi_common import K, run_joint_future
from torch_rnn_common import K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows
from torch_variant_common import cat_cfg
from trafficbotsv15_tpu.config import DistEncoderCfg as JaxDistEncoderCfg
from trafficbotsv15_tpu.ops import distributions as jd
from trafficbotsv15_tpu_torch.config import DistEncoderCfg, LatentEncoderCfg
from trafficbotsv15_tpu_torch.ops import distributions as pd

set_threads()
TOL = 1e-6


def _logits(seed=0, shape=(3, 5, 4, 6)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_jax_categorical_is_gumbel_max():
    """The noise the parity tests inject: JAX's categorical draw is argmax(logits + gumbel(key, logits.shape))."""
    logits = jnp.asarray(_logits())
    key = jax.random.PRNGKey(7)
    idx = jax.random.categorical(key, logits, axis=-1)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(jnp.argmax(logits + jax.random.gumbel(
        key, logits.shape, logits.dtype), -1)))


def test_probs_and_log_prob_match_jax():
    logits = _logits()
    onehot = np.eye(6, dtype=np.float32)[np.random.default_rng(1).integers(0, 6, (3, 5, 4))].reshape(3, 5, 24)
    jdist, pdist = jd.MultiCategorical(jnp.asarray(logits)), pd.MultiCategorical(_t(logits))
    np.testing.assert_allclose(t2n(pdist.probs), np.asarray(jdist.probs), rtol=0, atol=TOL)
    np.testing.assert_allclose(t2n(pdist.log_prob(_t(onehot))), np.asarray(jdist.log_prob(jnp.asarray(onehot))),
                               rtol=0, atol=TOL)
    assert (pdist.n_cat, pdist.n_class) == (4, 6)


@pytest.mark.parametrize("det", ["none", "all", "mask"])
def test_draws_with_jax_noise_match_jax(det):
    """JAX's draw equals the port's for JAX's noise: straight-through where not deterministic, the argmax one-hot
    where it is (a bool, or a per-element mask as the K0 future takes)."""
    logits = _logits()
    key = jax.random.PRNGKey(3)
    mask = {"none": False, "all": True, "mask": np.random.default_rng(2).random((3, 5)) < 0.5}[det]
    jdraw = jd.MultiCategorical(jnp.asarray(logits)).sample(key, mask if isinstance(mask, bool) else jnp.asarray(mask))
    pdist = pd.MultiCategorical(_t(logits))
    gumbel = _t(jax.random.gumbel(key, logits.shape, jnp.float32))
    m = torch.as_tensor(mask)
    want = torch.where(torch.broadcast_to(m, (3, 5))[..., None], pdist.sample(None, True), pdist.rsample(gumbel))
    np.testing.assert_allclose(t2n(want), np.asarray(jdraw), rtol=0, atol=TOL)
    assert tuple(want.shape) == (3, 5, 24) and set(np.unique(np.round(t2n(want), 6))) <= {0.0, 1.0}


def test_port_sample_takes_its_noise_where_not_deterministic():
    """`sample(generator, mask)` is the argmax one-hot where masked and `rsample(noise(generator))` elsewhere."""
    pdist = pd.MultiCategorical(_t(_logits()))
    mask = torch.from_numpy(np.random.default_rng(4).random((3, 5)) < 0.5)
    got = pdist.sample(torch.Generator().manual_seed(5), mask)
    want = torch.where(mask[..., None], pdist.sample(None, True), pdist.rsample(pdist.noise(
        torch.Generator().manual_seed(5))))
    assert torch.equal(got, want)


def test_straight_through_gradient_matches_jax():
    """d(sum(w * draw))/d(logits) flows through the probabilities, as JAX's straight-through estimator."""
    logits, w = _logits(), _logits(seed=9, shape=(3, 5, 24))
    key = jax.random.PRNGKey(11)
    jgrad = jax.grad(lambda lg: jnp.sum(jnp.asarray(w) * jd.MultiCategorical(lg).sample(key)))(jnp.asarray(logits))
    lg = _t(logits).requires_grad_()
    gumbel = _t(jax.random.gumbel(key, logits.shape, jnp.float32))
    (_t(w) * pd.MultiCategorical(lg).rsample(gumbel)).sum().backward()
    assert float(lg.grad.abs().max()) > 0
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jgrad), rtol=0, atol=TOL)


def test_kl_multi_categorical_matches_jax():
    p, q = _logits(1), _logits(2)
    want = jd.kl_multi_categorical(jd.MultiCategorical(jnp.asarray(p)), jd.MultiCategorical(jnp.asarray(q)))
    got = pd.kl_multi_categorical(pd.MultiCategorical(_t(p)), pd.MultiCategorical(_t(q)))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("alpha", [0.0, 0.2])
@pytest.mark.parametrize("free_nats", [0.0, 0.5])
def test_balanced_kl_matches_jax(alpha, free_nats):
    """The balanced KL of two MultiCategoricals and its gradients to both logits (the stop-gradients place them);
    free nats 0.5 clamps some of the 15 values and not others."""
    p, q = _logits(1, (3, 5, 2, 2)), 0.5 * _logits(2, (3, 5, 2, 2))
    w = _logits(3, (3, 5))

    def jloss(lp, lq):
        err = jd.balanced_kl(jd.MultiCategorical(lp), jd.MultiCategorical(lq), alpha, free_nats)
        return jnp.sum(jnp.asarray(w) * err), err

    (_, jerr), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(p), jnp.asarray(q))
    tp, tq = _t(p).requires_grad_(), _t(q).requires_grad_()
    err = pd.balanced_kl(pd.MultiCategorical(tp), pd.MultiCategorical(tq), alpha, free_nats)
    (_t(w) * err).sum().backward()
    np.testing.assert_allclose(t2n(err), np.asarray(jerr), rtol=0, atol=TOL)
    if free_nats:
        clamped = np.asarray(jerr) == free_nats * (1 + alpha)
        assert clamped.any() and not clamped.all()
    for got, want in ((tp.grad, jgrads[0]), (tq.grad, jgrads[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _dist_encoders(dist_type: str, branch_type: bool):
    """(JAX DistEncoder, its random params, the port's head loaded with them) at hidden 16, latent 8, n_cat 4."""
    from trafficbotsv15_tpu.models.latent_encoder import DistEncoder
    from trafficbotsv15_tpu_torch.models.latent_encoder import dist_encoder
    from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

    jm = DistEncoder(cfg=JaxDistEncoderCfg(dist_type=dist_type, branch_type=branch_type, n_cat=4), hidden_dim=16,
                     out_dim=8)
    x, valid, ag_type = _inputs()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, valid, ag_type))
    params = random_tree(shapes, seed=5)["params"] if "params" in shapes else {}
    head = dist_encoder(DistEncoderCfg(dist_type=dist_type, branch_type=branch_type, n_cat=4), 16, 8, 3)
    head.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, head


def _inputs():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    valid = rng.random((2, 7)) < 0.8
    ag_type = np.eye(3, dtype=bool)[rng.integers(0, 3, (2, 7))]
    return jnp.asarray(x), jnp.asarray(valid), jnp.asarray(ag_type)


@pytest.mark.parametrize("dist_type,branch_type", [("cat", False), ("cat", True), ("std_cat", False)])
def test_dist_encoder_matches_jax(dist_type, branch_type):
    jm, params, head = _dist_encoders(dist_type, branch_type)
    x, valid, ag_type = _inputs()
    jdist = jm.apply({"params": params}, x, valid, ag_type)
    pdist = head(_t(x), _t(valid), _t(ag_type))
    assert isinstance(pdist, pd.MultiCategorical) and head.skips_forward == (dist_type == "std_cat")
    assert tuple(pdist.logits.shape) == (2, 7, 4, 2)
    np.testing.assert_allclose(t2n(pdist.logits), np.asarray(jdist.logits), rtol=1e-4, atol=1e-5)
    assert torch.equal(pdist.valid, _t(valid))


def test_a_tie_draws_the_first_class():
    """std_cat's logits are all zero: the deterministic draw is a tie of every class, and both packages take the
    first (jnp.argmax and torch.argmax)."""
    logits = np.zeros((2, 3, 4, 5), np.float32)
    jdraw = np.asarray(jd.MultiCategorical(jnp.asarray(logits)).sample(jax.random.PRNGKey(0), True))
    pdraw = t2n(pd.MultiCategorical(_t(logits)).sample(None, True))
    want = np.tile(np.eye(5, dtype=np.float32)[0], (2, 3, 4)).reshape(2, 3, 20)
    np.testing.assert_array_equal(pdraw, want)
    np.testing.assert_array_equal(jdraw, want)


@pytest.mark.parametrize("post,prior,n_cat", [("diag_gaus", "std_cat", 8), ("cat", "std_gaus", 8),
                                              ("cat", "cat", 3), ("cat", "std_cat", 0)])
def test_latent_families_must_agree(post, prior, n_cat):
    """A Gaussian posterior with a categorical prior (or the reverse) has no KL (JAX fails on it in the loss), and
    categorical factors must divide latent_dim 16 alike: the port refuses these when the model is built."""
    from trafficbotsv15_tpu_torch.models.latent_encoder import check_latent_cfg

    cfg = LatentEncoderCfg(latent_post=DistEncoderCfg(dist_type=post, n_cat=8),
                           latent_prior=DistEncoderCfg(dist_type=prior, n_cat=n_cat or 4))
    with pytest.raises(ValueError):
        check_latent_cfg(cfg)
    check_latent_cfg(dataclasses.replace(cfg, latent_dim=0))  # no latent: nothing to agree


def test_training_noise_is_gumbel_of_the_logits_shape():
    """A categorical latent's training noise is standard Gumbel [n_sc, n_ag, n_cat, n_class]; a Gaussian one's
    standard normal [n_sc, n_ag, latent_dim]."""
    from trafficbotsv15_tpu_torch.train.pipeline import latent_noise

    cfg = port_cfg(cat_cfg())
    g = latent_noise(cfg, 2000, 8, torch.Generator().manual_seed(0))
    assert tuple(g.shape) == (2000, 8, 2, 2)
    assert abs(float(g.mean()) - 0.5772) < 0.02 and abs(float(g.std()) - 1.2825) < 0.02  # Euler's gamma, pi/sqrt(6)
    gauss = latent_noise(port_cfg(dataclasses.replace(cat_cfg(), model=dataclasses.replace(
        cat_cfg().model, latent_encoder=dataclasses.replace(cat_cfg().model.latent_encoder, latent_post=JaxDistEncoderCfg(),
                                                            latent_prior=JaxDistEncoderCfg(dist_type="std_gaus"))))),
                         2, 8, torch.Generator().manual_seed(0))
    assert tuple(gauss.shape) == (2, 8, 4)


ARMS = {"cat-branch-cat": dict(prior="cat", branch_type=True), "cat-std_cat": dict(prior="std_cat",
                                                                                    branch_type=False)}


@pytest.fixture(scope="module", params=sorted(ARMS))
def run(request):
    return run_joint_future(cat_cfg(**ARMS[request.param]))


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_cat_joint_future_pred_k0_rows(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_cat_rollout_with_injected_samples_every_row(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_cat_rollout_rule_flags(run):
    assert_flags(run["jroll"], run["injected"])
    assert_flags(run["jbuf"], run["pbuf"], k0_only=True)


def test_cat_k0_latent_is_the_priors_argmax_one_hot(run):
    """JAX's K0 latent is the one-hot of the argmax of the port's own prior logits (for std_cat the tie's first
    class); every other future's a one-hot draw, flattened [n_sc * K, n_ag, n_cat * n_class]."""
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval

    cfg = run["cfg"]
    batch = port_eval.batch_to_device(run["batch"], torch.device("cpu"))
    prior = port_eval.prepare_joint_future(cfg, run["model"], batch).latent_prior
    lat = run["samples"]["ag_latent"]
    assert tuple(lat.shape) == (2 * K, cfg.data.n_ag, cfg.model.latent_encoder.latent_dim)
    # a straight-through draw is one-hot + p - p: within a rounding of 0 or 1
    assert set(np.unique(np.round(lat.numpy(), 6))) <= {0.0, 1.0}
    assert np.allclose(lat.reshape(2 * K, -1, 2, 2).sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
    mode = torch.nn.functional.one_hot(prior.logits.argmax(-1), 2).float().reshape(lat[::K].shape)
    assert torch.equal(lat[::K], mode)
    if cfg.model.latent_encoder.latent_prior.dist_type == "std_cat":
        assert (lat[::K].reshape(2, -1, 2, 2)[..., 0] == 1).all()
    assert torch.isfinite(run["pbuf"].log_prob).all()


@pytest.fixture(scope="module")
def sims():
    """The serving entry point at `tests/test_torch_serve.py`'s config with a `cat` posterior and prior."""
    from test_torch_serve import STATIC_SAMPLES, _serve_cfg
    from trafficbotsv15_tpu.data.synthetic import make_batch
    from trafficbotsv15_tpu.serve import InteractiveSimulator as JaxSimulator
    from trafficbotsv15_tpu_torch.serve import InteractiveSimulator

    base = _serve_cfg(False)
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, latent_encoder=cat_cfg().model.latent_encoder))
    _, tree = jax_model_params(cfg, seed=0, gain=0.5)
    batch = make_batch(cfg.data, n_sc=1, seed=9)
    key = jax.random.PRNGKey(1)
    with jax_sort_knn():
        jsim = JaxSimulator(cfg, to_jnp(tree))
        jsim.reset({k: jnp.asarray(v) for k, v in batch.items()}, key)
        jouts = [jsim.step() for _ in range(6)]
    jstatic = {k: torch.from_numpy(np.array(v)) for k, v in zip(STATIC_SAMPLES, jsim._state[6][4:])}
    psim = InteractiveSimulator(port_cfg(cfg), port_model(cfg, tree), device="cpu")
    psim.reset(batch, torch.Generator().manual_seed(1))
    own = dict(psim.static)
    psim.static.update(jstatic)
    pouts = [psim.step() for _ in range(6)]
    k_lat = jax.random.split(jax.random.split(key)[0])[0]
    return dict(psim=psim, batch=batch, jstatic=jstatic, own=own, jouts=jouts, pouts=pouts, k_lat=k_lat)


def test_serve_reset_latent_matches_jax(sims):
    """Reset's latent: the port's prior with JAX's Gumbel noise (`InteractiveSimulator` keys: reset splits
    (encode, carry), encode splits (latent, navi)) gives JAX's draw; the port's own draw is a one-hot of that
    shape."""
    from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
    from trafficbotsv15_tpu_torch.train.evaluation import batch_to_device

    psim = sims["psim"]
    cfg = psim.cfg
    b = batch_to_device(sims["batch"], torch.device("cpu"))
    pp = pre_processing(b, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode, n_step_hist=cfg.n_step_hist,
                        training=True)
    st = psim.static
    with torch.no_grad():
        prior = psim.model.encode_latent(pp.ag_valid, pp.ag_attr, pp.ag_motion, pp.ag_pose, pp.ag_type,
                                         pp.tl_state.float(), st["mp_tokens"], st["tl_tokens"], posterior=False)
    noise = _t(jax.random.gumbel(sims["k_lat"], tuple(prior.logits.shape), jnp.float32))
    np.testing.assert_array_equal(t2n(prior.rsample(noise)), sims["jstatic"]["ag_latent"].numpy())
    np.testing.assert_array_equal(sims["own"]["ag_latent_valid"].numpy(), sims["jstatic"]["ag_latent_valid"].numpy())
    own = sims["own"]["ag_latent"]
    assert own.shape == sims["jstatic"]["ag_latent"].shape
    assert np.allclose(own.reshape(*own.shape[:2], 2, 2).sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("key,atol", [("pose", 1e-3), ("motion", 1e-3), ("action", 1e-3), ("valid", 0),
                                      ("tl_state", 0)])
def test_serve_steps_with_the_jax_latent_match_jax(sims, key, atol):
    for t, (j, p) in enumerate(zip(sims["jouts"], sims["pouts"])):
        np.testing.assert_allclose(p[key], np.asarray(j[key]), rtol=0, atol=atol, err_msg=f"step {t}")


@pytest.mark.parametrize("prior", ["cat", "std_cat"])
def test_learned_prior_calls_its_encoders_kernels(prior, monkeypatch):
    """With use_pallas at 512 polylines (the KNN kernel's gate), a learned `cat` prior runs its own TL and agent
    encoders once per joint_future_pred call: one more KNN, B2 once per TL layer (its TL tokens over their nearest map
    polylines) and per agent layer, beside the rollout's; the constant `std_cat` prior runs none (as `std_gaus`)."""
    from torch_rnn_common import count_wrappers
    from trafficbotsv15_tpu.config import tiny_config
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    base = cat_cfg(prior=prior)
    jcfg = dataclasses.replace(tiny_config(n_mp=512), model=dataclasses.replace(
        base.model, tf_cfg=dataclasses.replace(base.model.tf_cfg, use_pallas=True)))
    cfg = port_cfg(jcfg)
    calls = count_wrappers(monkeypatch)
    port_eval.joint_future_pred(cfg, build_model(cfg, seed=0, device="cpu"), make_batch(cfg.data, n_sc=1, seed=0),
                                generator=torch.Generator().manual_seed(0), n_joint_future=K, device="cpu")
    m, n, learned = cfg.model, cfg.time_step_end, int(prior == "cat")
    assert len(calls["knn_xy"]) == n + learned
    assert len(calls["knarpe_attention"]) == m.mp_encoder.n_layer_tf
    assert len(calls["knarpe_cross_attention"]) == (m.ag_encoder.n_layer_tf * n
                                                    + learned * (m.tl_encoder.n_layer_tf + m.ag_encoder.n_layer_tf))
