"""PyTorch port: one training step with categorical latents against the JAX package.

`tests/test_torch_helpers.py::train_step_parity`: JAX `jax.jit(jax.value_and_grad(training_forward))` and the
port's `make_train_step` on the same gain-0.5 weights and batch, every dropout rate at 0, JAX's draws handed to the
port; the latent's noise is JAX's Gumbel noise of the logits' shape (`jax_latent_noise`: both the posterior's and
the prior's draw take it, as JAX `_select_latent` samples both with one key). Arms (`tests/torch_variant_common.py`):
a type-branched `cat` posterior with a learned `cat` prior and free nats 0, so that the balanced KL and its two
stop-gradients reach both heads; a plain `cat` posterior with the `std_cat` prior at the default free nats. The
straight-through draw carries the rollout's gradient into the posterior's logits in both. Every loss term and
grad_norm to 1e-5 relative, every parameter's gradient to 1e-4 of its largest magnitude + 1e-7.
"""

import pytest
import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches, no_dropout, train_step_parity
from torch_variant_common import cat_cfg

torch.set_num_threads(2)

ARMS = {"branch-cat-free0": dict(prior="cat", branch_type=True, free_nats=0.0),
        "plain-std_cat": dict(prior="std_cat", branch_type=False)}


@pytest.fixture(scope="module", params=sorted(ARMS))
def run(request):
    return dict(train_step_parity(no_dropout(cat_cfg(**ARMS[request.param]))), arm=request.param)


def test_cat_training_step_loss_matches_jax(run):
    assert_loss_matches(run)
    kl = run["port_metrics"]["training/vae_kl"]
    assert kl > 0
    if run["arm"] == "branch-cat-free0":
        assert kl != 1.2  # not clamped at the free nats


def test_cat_training_step_grads_match_jax(run):
    assert_grads_match(run)


def test_cat_latent_heads_learn(run):
    """The posterior's logits MLPs (one per agent type where branched) and, with a learned prior, the prior's get
    gradient: through the KL and, for the posterior, through the straight-through draw."""
    grads = run["port_grads"]
    heads = ["latent_encoder.dist_post.logits"]
    if run["arm"] == "branch-cat-free0":
        heads = [f"latent_encoder.dist_post.logits{i}." for i in range(3)] + ["latent_encoder.dist_prior.logits."]
    for prefix in heads:
        got = [g for n, g in grads.items() if n.startswith(prefix)]
        assert got and any(float(g.abs().max()) > 0 for g in got), prefix
