"""PyTorch port: the TrafficBots RNN family's `reactive_replay` (tiny_config, temp_window_size=0) against the JAX
package, with use_pallas False and True (dense_knn_max 4; plain kernel versions on the CPU), check_level 1.

Reactive replay draws nothing: the posterior latent's mean, the logged destinations, every agent spawned from
the log, TL forced to the log and run inside the rollout with the GRU TL state predictor's hidden carried.
Both packages' calls on the same gain-0.5 weights and batch (JAX's under jit): every buffer field, the
rewards and the rule flags of every row, the navi logits and the posterior mean, at the tolerances of
`tests/torch_rnn_common.py` (the navi logits and latent mean 2e-4, `tests/test_torch_models.py`'s for whole
encoders).
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import t2n
from torch_rnn_common import ROW_FIELDS, assert_flags, assert_rows, rnn_cfg, run_reactive_replay

torch.set_num_threads(2)
FIELDS = [f for f in ROW_FIELDS if not f[0].startswith("navi_log_prob")]


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "pallas"])
def run(request):
    return run_reactive_replay(rnn_cfg(use_pallas=request.param), check_level=1)


@pytest.mark.parametrize("field,atol", FIELDS)
def test_rnn_reactive_replay_every_row(run, field, atol):
    (jbuf, _, _), (pbuf, _, _) = run
    assert_rows(jbuf, pbuf, field, atol)


def test_rnn_reactive_replay_rule_flags_and_rewards(run):
    (jbuf, _, _), (pbuf, _, _) = run
    assert_flags(jbuf, pbuf)
    assert set(pbuf.diffbar_reward) == set(jbuf.diffbar_reward)
    for key, val in jbuf.diffbar_reward.items():
        np.testing.assert_allclose(t2n(pbuf.diffbar_reward[key]), np.asarray(val, np.float32), rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("i,name", [(1, "navi_logits"), (2, "latent_post_mean")])
def test_rnn_reactive_replay_encoders(run, i, name):
    want, got = run[0][i], run[1][i]
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32), rtol=0, atol=2e-4, err_msg=name)
