"""PyTorch port: one training step in the goal and cmd navigation modes against the JAX package.

`test_torch_helpers.train_step_parity`: the JAX `jax.jit(jax.value_and_grad(training_forward))` and the port's
`make_train_step` on the same gain-0.5 weights and batch, the JAX draws handed to the port, every dropout rate
at 0. goal with use_pallas False (the goal's NLL under the predictor's DiagGaussian, its learned log_std among the
gradients); cmd with AddNaviLatent `add` and use_pallas at dense_knn_max 4 (the navi predictor's tf_ag2mp and its
backward through B2's wrapper; the one-hot command's index in the NLL). Every loss term and grad_norm to 1e-5
relative, every parameter's gradient to 1e-4 of its largest magnitude + 1e-7 (`tests/test_torch_helpers.py`).
"""

import pytest
import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches, no_dropout, train_step_parity
from torch_navi_common import navi_cfg

torch.set_num_threads(2)

ARMS = {"goal": dict(navi_mode="goal"), "cmd-add-pallas": dict(navi_mode="cmd", add_mode="add", use_pallas=True)}


@pytest.fixture(scope="module", params=sorted(ARMS))
def run(request):
    return train_step_parity(no_dropout(navi_cfg(**ARMS[request.param])))


def test_navi_training_step_loss_matches_jax(run):
    assert_loss_matches(run)
    assert run["port_metrics"]["training/navi_loss"] != 0


def test_navi_training_step_grads_match_jax(run):
    assert_grads_match(run)


def test_navi_predictor_and_encoder_learn(run):
    """The goal / cmd predictor's cross-attention and MLP, the goal's log_std, and the navi encoder's MLP all get
    gradient."""
    mode = run["model"].cfg.navi_mode
    prefixes = ["navi_predictor.tf_ag2mp.", "navi_predictor.mlp.", "navi_encoder.mlp.", "add_navi.mlp."]
    if mode == "goal":
        prefixes.append("navi_predictor.log_std")
    for prefix in prefixes:
        grads = [g for n, g in run["port_grads"].items() if n.startswith(prefix)]
        assert grads and any(float(g.abs().max()) > 0 for g in grads), prefix
