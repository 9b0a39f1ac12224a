"""PyTorch port: one training step with the pose-embedding RPE modes and apply_q_rpe against the JAX package.

`tests/torch_variant_common.py::train_parity`, as `tests/test_torch_variants_train.py`: `pose_rpe` in mode
`pe_xy_dir`; in mode `xy_dir` (a 4-wide RPE) with use_pallas at dense_knn_max 4, so that every B4 and B2 wrapper
and its backward take d_rpe = 4 (the plain versions on the CPU); and `apply_q_rpe` held against JAX's model without
it through zero query rows of rpe_proj (JAX's model fails on apply_q_rpe): the k and v rows' gradients against
JAX's rpe_proj_w and rpe_proj_b, the query rows' finite and non-zero. Every loss term and grad_norm to 1e-5
relative, every parameter's gradient to 1e-4 of its largest magnitude + 1e-7.
"""

import pytest
import torch

from test_torch_helpers import assert_grads_match, assert_loss_matches
from torch_variant_common import train_parity

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["pe_xy_dir", "xy_dir", "q_rpe"])
def run(request):
    return dict(train_parity(request.param), name=request.param)


def test_rpe_variant_training_step_loss_matches_jax(run):
    assert_loss_matches(run)


def test_rpe_variant_training_step_grads_match_jax(run):
    assert_grads_match(run)


def test_query_rpe_rows_learn(run):
    """With apply_q_rpe the query rows of every rpe_proj get gradient (rpe_q starts at 0: its gradient is q's
    partner k + rpe_k); the other arms have no such rows."""
    rows = run.get("q_rows", {})
    assert bool(rows) == (run["name"] == "q_rpe")
    for key, g in rows.items():
        assert torch.isfinite(g).all(), key
    if rows:
        assert any(float(g.abs().max()) > 0 for k, g in rows.items() if k.endswith("weight"))
