"""PyTorch port: one training step against `jax.value_and_grad(training_forward)`, use_pallas=True.

As test_torch_train_grad.py (tolerances stated there), with
`TransformerCfg(use_pallas=True, dense_knn_max=16)`: the 32 polylines take
the project-then-gather route through B4 and its backward, and the rollout's
agent decoder and the posterior TL and agent encoders the fused K/V + RPE
route through B2 and its backward, in both packages (the JAX package takes
its `knarpe_*_reference` on the CPU and differentiates it; the port's
autograd Functions take the plain backwards).
"""

import dataclasses

import pytest

from test_torch_helpers import assert_grads_match, assert_loss_matches, no_dropout, set_threads, train_step_parity
from trafficbotsv15_tpu.config import tiny_config

set_threads()


def pallas_cfg():
    cfg = no_dropout(tiny_config())
    tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=True, dense_knn_max=16)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))


@pytest.fixture(scope="module")
def run():
    return train_step_parity(pallas_cfg())


def test_use_pallas_train_step_loss_and_grad_norm_match_jax(run):
    assert_loss_matches(run)


def test_use_pallas_train_step_every_parameter_gradient_matches_jax(run):
    assert_grads_match(run)


def test_use_pallas_kernel_weights_get_gradients(run):
    """The weights that only B4 and B2 read (rpe projections of the map encoder, K/V and rpe
    projections of the agent decoder's cross-attention) get non-zero gradients."""
    for prefix in ("mp_encoder.tf_mp2mp.layer0.attn.rpe_proj", "ag_encoder.tf_ag2agmptl.layer0.attn.kv_",
                   "ag_encoder.tf_ag2agmptl.layer0.attn.rpe_proj",
                   "latent_encoder.tl_encoder_post.tf_tl2tlmp.layer0.attn.kv_"):
        hits = [g for n, g in run["port_grads"].items() if n.startswith(prefix)]
        assert hits and all(float(g.abs().max()) > 0 for g in hits), prefix
