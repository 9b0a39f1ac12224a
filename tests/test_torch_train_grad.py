"""PyTorch port: one training step against `jax.value_and_grad(training_forward)`, use_pallas=False.

tiny_config with every dropout rate at 0 (JAX keys and torch generators never
draw the same masks; the port's dropout is tested in test_torch_train.py),
random weights of gain 0.5 (the random closed loop is chaotic at gain 1, see
test_torch_slice.py), two synthetic scenarios, 20 rollout steps, the KNN on
the stable sort in both. The JAX step's own draws (history dropout, the
prior-or-posterior choice, the latent noise, the random agent forcing) are
handed to the port. Compared: every loss term and the loss within 1e-5
relative, `grad_norm` within 1e-5 relative, and every parameter's gradient
within 1e-4 of that parameter's largest JAX gradient plus 1e-7 (float32
through 20 BPTT steps, reduction order only; measured <= 5e-6 and <= 5e-9).
"""

import pytest
import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches, no_dropout, set_threads, train_step_parity
from trafficbotsv15_tpu.config import tiny_config

set_threads()


@pytest.fixture(scope="module")
def run():
    return train_step_parity(no_dropout(tiny_config()))


def test_train_step_loss_and_grad_norm_match_jax(run):
    assert_loss_matches(run)


def test_train_step_every_parameter_gradient_matches_jax(run):
    assert_grads_match(run)


def test_folded_target_layernorm_gets_its_gradient(run):
    """norm_tgt_scale / norm_tgt_bias reach the loss only through their fold into W_kv and b."""
    names = [n for n in run["port_grads"] if n.endswith(("norm_tgt_scale", "norm_tgt_bias"))]
    assert any(n.startswith("ag_encoder.") for n in names) and any(n.startswith("latent_encoder.") for n in names)
    for n in names:
        if n.startswith(("ag_encoder.", "latent_encoder.")):
            assert float(run["port_grads"][n].abs().max()) > 0, n


def test_every_module_learns(run):
    """Each top-level module gets a non-zero gradient (a wrapper without grad_fn would leave some at 0)."""
    tops = {n.split(".")[0] for n in run["port_grads"]}
    for top in tops:
        total = sum(float(g.abs().sum()) for n, g in run["port_grads"].items() if n.startswith(top + "."))
        assert total > 0, top
    assert torch.isfinite(torch.tensor(run["port_metrics"]["training/loss"]))
