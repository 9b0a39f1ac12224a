"""PyTorch port: one training step in the TL and input variants against the JAX package.

`tests/torch_variant_common.py::train_parity` (`tests/test_torch_helpers.py::train_step_parity`: JAX
`jax.jit(jax.value_and_grad(training_forward))` and the port's `make_train_step` on the same gain-0.5 weights and
batch, JAX's draws handed to the port, every dropout rate at 0) with TL tokens at stop lines, the stacked-input TL
encoder, and InputEncoder mode `input`. Every loss term and grad_norm to 1e-5 relative, every parameter's gradient
to 1e-4 of its largest magnitude + 1e-7. The pose-embedding and apply_q_rpe arms are
`tests/test_torch_variants_train_rpe.py`'s.
"""

import pytest
import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches
from torch_variant_common import train_parity

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["stop", "stacked", "input"])
def run(request):
    return train_parity(request.param)


def test_variant_training_step_loss_matches_jax(run):
    assert_loss_matches(run)


def test_variant_training_step_grads_match_jax(run):
    assert_grads_match(run)
