"""PyTorch port: training-step gradients against JAX with one stop-gradient switch turned off.

The detach switches decide where gradients stop; forward parity cannot see a
misplaced detach, so each is turned off in both packages and one training
step is compared as in test_torch_train_grad.py (tolerances stated there):
`training_detach_model_input` and `tl_state_predictor.detach_tl_feature` here, the
others in the other test_torch_train_detach_*.py files. Each case also shows that the switch moves
the port's gradients, so the comparison is not vacuous.
"""

import pytest
import torch

from test_torch_helpers import (DETACH_FLAGS, assert_grads_match, assert_loss_matches, flip_detach, no_dropout,
                                port_grads, set_threads, train_step_parity)
from trafficbotsv15_tpu.config import tiny_config

set_threads()
FLAGS = DETACH_FLAGS[:2]


@pytest.fixture(scope="module", params=FLAGS)
def flipped(request):
    cfg = flip_detach(no_dropout(tiny_config()), request.param)
    return request.param, cfg, train_step_parity(cfg)


def test_detach_flag_off_loss_matches_jax(flipped):
    assert_loss_matches(flipped[2])


def test_detach_flag_off_every_parameter_gradient_matches_jax(flipped):
    assert_grads_match(flipped[2])


@pytest.fixture(scope="module")
def default_grads():
    return port_grads(no_dropout(tiny_config()))


def test_detach_flag_moves_the_gradients(flipped, default_grads):
    flag, _, run = flipped
    default = default_grads
    moved = [n for n, g in run["port_grads"].items() if not torch.allclose(g, default[n], rtol=1e-3, atol=1e-8)]
    assert moved, flag
