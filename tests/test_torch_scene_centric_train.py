"""PyTorch port: one training step of the scene-centric model and of the last transformer and pooling options against
the JAX package, on the CPU.

`tests/test_torch_helpers.py::train_step_parity` (JAX `jax.jit(jax.value_and_grad(training_forward))` and the port's
`make_train_step` on the same gain-0.5 weights and batch, JAX's draws handed to the port, every dropout rate at 0) in
two scene-centric arms: `hptr_stop_options` (HPTR, stop-line TL tokens with their pose embedding, dest navi, gelu
FFNs, `mean_valid` pooling, dropout on the attention weights at p = 0, use_pallas at dense_knn_max 4) and `rnn_goal`
(the TrafficBots RNN family, lane TL tokens, goal navi, use_pallas; its TL state predictor's `rnn_dropout_p` at 0
too). Every loss term and grad_norm to 1e-5 relative, every parameter's gradient to 1e-4 of its largest magnitude +
1e-7.
"""

import dataclasses

import pytest

from test_torch_helpers import assert_grads_match, assert_loss_matches, no_dropout, set_threads, train_step_parity
from torch_navi_common import navi_cfg

set_threads()


def train_cfg(name: str):
    if name == "hptr_stop_options":
        cfg = navi_cfg("dest", use_pallas=True)
        m = cfg.model
        tf = dataclasses.replace(m.tf_cfg, activation="gelu", attn_dropout_weights=True)
        pl = dataclasses.replace(m.mp_encoder.pl_encoder, pooling_mode="mean_valid")
        m = dataclasses.replace(m, pairwise_relative=False, tl_mode="stop", tf_cfg=tf,
                                mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=pl))
    else:
        cfg = navi_cfg("goal", use_pallas=True)
        m = cfg.model
        m = dataclasses.replace(m, pairwise_relative=False, temp_window_size=0, tl_state_predictor=dataclasses.replace(
            m.tl_state_predictor, rnn_dropout_p=0.0))
    return no_dropout(dataclasses.replace(cfg, model=m))


@pytest.fixture(scope="module", params=["hptr_stop_options", "rnn_goal"])
def run(request):
    return train_step_parity(train_cfg(request.param))


def test_training_step_loss_matches_jax(run):
    assert_loss_matches(run)


def test_training_step_grads_match_jax(run):
    assert_grads_match(run)
