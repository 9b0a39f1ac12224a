"""PyTorch port: one training step of the TrafficBots RNN family (tiny_config, temp_window_size=0) against the
JAX package, use_pallas False.

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
    return train_step_parity(rnn_train_cfg(use_pallas=False))


def test_rnn_training_step_loss_matches_jax(run):
    assert_loss_matches(run)
    assert run["port_metrics"]["training/tl_state_loss"] > 0  # the in-rollout TL-state NLL reaches the loss


def test_rnn_training_step_grads_match_jax(run):
    assert_grads_match(run)


def test_rnn_training_step_reaches_every_gru(run):
    """The GRUs of the agent encoder, the posterior, the navi predictor and the TL state predictor all get
    gradient (the TL one through the NLL of the state it predicts)."""
    for prefix in ("ag_encoder.temp_encoder.gru0.", "latent_encoder.ag_encoder_post.temp_encoder.gru0.",
                   "navi_predictor.temp_encoder.gru0.", "tl_state_predictor.rnn.gru0."):
        grads = [g for n, g in run["port_grads"].items() if n.startswith(prefix)]
        assert grads and all(torch.isfinite(g).all() for g in grads), prefix
        assert any(g.abs().max() > 0 for g in grads), prefix


def test_rnn_training_step_kernel_wrappers(monkeypatch):
    """The wrapper calls of one RNN training step with use_pallas (dense_knn_max 4) and 512 polylines, forward
    and the per-step recompute of the backward: the agent->map KNN once per rollout step and once per
    recomputed step at [n_sc, n_ag, 512], once in the flattened posterior at [n_sc, n_ag * 5 down-sampled steps,
    512]; B2 per tf_ag2mp (K=8) and tf_ag2tl (K=3) layer and step, twice, and per posterior layer over the
    flattened sources and over [n_sc * 5, n_ag]; B4 per map layer, per tf_ag2ag layer and step, twice, and per
    posterior tf_ag2ag layer."""
    import collections
    import dataclasses

    from test_torch_helpers import port_cfg
    from torch_rnn_common import count_wrappers
    from trafficbotsv15_tpu.config import tiny_config
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch
    from trafficbotsv15_tpu_torch.train import pipeline

    cfg = port_cfg(dataclasses.replace(rnn_train_cfg(use_pallas=True), data=tiny_config(n_mp=512).data))
    model = pipeline.build_model(cfg, seed=0, device="cpu").train()
    calls = count_wrappers(monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg.data, n_sc=2, seed=0).items()}
    noise = pipeline.draw_training_noise(cfg, batch, torch.Generator().manual_seed(0), "cpu")
    loss, _ = pipeline.training_forward(cfg, model, batch, noise)
    loss.backward()
    n, n_ag, d, lay = cfg.time_step_end, cfg.data.n_ag, cfg.model.hidden_dim, cfg.model.ag_encoder.n_layer_tf
    n_post = n_ag * ((cfg.time_step_gt + 1 + 4) // 5)  # the posterior's flattened sources
    assert {k: dict(collections.Counter(v)) for k, v in calls.items()} == {
        "knn_xy": {(2, n_ag, 2, 512, 8): 2 * n, (2, n_post, 2, 512, 8): 1},
        "knarpe_attention": {(2, 512, d, cfg.model.n_tgt_knn): cfg.model.mp_encoder.n_layer_tf,
                             (2, n_ag, d, 3): 2 * lay * n, (2 * n_post // n_ag, n_ag, d, 3): lay},
        "knarpe_cross_attention": {(2, n_ag, d, 8): 2 * lay * n, (2, n_ag, d, 3): 2 * lay * n,
                                   (2, n_post, d, 8): lay, (2 * n_post // n_ag, n_ag, d, 3): lay}}
