"""PyTorch port: one training step of the TrafficBots RNN family (tiny_config, temp_window_size=0) against the
JAX package, use_pallas True (dense_knn_max 4: the map and the agent self-attentions through B4 and its
backward, the agent cross-attentions and the posterior's through B2 and its backward; plain versions on the
CPU).

`test_torch_helpers.train_step_parity`: the JAX `jax.jit(jax.value_and_grad(training_forward))` and the
port's `make_train_step` on the same gain-0.5 weights and batch, the JAX draws handed to the port, every
dropout rate at 0 (the GRU TL state predictor's `rnn_dropout_p` too: JAX keys and torch generators never
draw the same masks), as `tests/test_rnn_mode.py` drives the JAX package. The flattened posterior latent
encoder, the GRU navi predictor, the in-rollout TL path and both GRU hiddens through the 20 BPTT steps under
the per-step recompute: every loss term and grad_norm to 1e-5 relative, every parameter's gradient to 1e-4 of
its largest magnitude + 1e-7 (`tests/test_torch_helpers.py`).
"""

import pytest
import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches, train_step_parity
from torch_rnn_common import rnn_train_cfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    return train_step_parity(rnn_train_cfg(use_pallas=True))


def test_rnn_pallas_training_step_loss_matches_jax(run):
    assert_loss_matches(run)
    assert run["port_metrics"]["training/tl_state_loss"] > 0  # the in-rollout TL-state NLL reaches the loss


def test_rnn_pallas_training_step_grads_match_jax(run):
    assert_grads_match(run)


def test_rnn_pallas_training_step_reaches_every_gru(run):
    """The GRUs of the agent encoder, the posterior, the navi predictor and the TL state predictor all get
    gradient (the TL one through the NLL of the state it predicts)."""
    for prefix in ("ag_encoder.temp_encoder.gru0.", "latent_encoder.ag_encoder_post.temp_encoder.gru0.",
                   "navi_predictor.temp_encoder.gru0.", "tl_state_predictor.rnn.gru0."):
        grads = [g for n, g in run["port_grads"].items() if n.startswith(prefix)]
        assert grads and all(torch.isfinite(g).all() for g in grads), prefix
        assert any(g.abs().max() > 0 for g in grads), prefix
