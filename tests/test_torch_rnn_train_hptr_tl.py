"""PyTorch port: one HPTR training step with `tl_prepass=False` against the JAX package.

JAX then runs the TL encoder and state predictor inside its remat'd rollout scan (`train/pipeline.py:161`);
the port inside `model.step` under the per-step recompute. `test_torch_helpers.train_step_parity` on
tiny_config at dropout 0: every loss term and grad_norm to 1e-5 relative, every parameter's gradient to 1e-4
of its largest magnitude + 1e-7.
"""

import dataclasses

import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches, no_dropout, train_step_parity
from trafficbotsv15_tpu.config import tiny_config

torch.set_num_threads(2)


def test_hptr_in_rollout_tl_training_step_matches_jax():
    run = train_step_parity(no_dropout(dataclasses.replace(tiny_config(), tl_prepass=False)))
    assert_loss_matches(run)
    assert_grads_match(run)
