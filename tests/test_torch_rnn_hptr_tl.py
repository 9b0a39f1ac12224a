"""PyTorch port: the in-rollout TL path in HPTR mode (`tl_prepass=False`) against the JAX package.

JAX runs the TL encoder and state predictor inside its rollout scan where `tl_prepass` is off
(`train/evaluation.py:79`); the port's counterpart runs them inside `model.step` on the rollout's TL
window, over the K-replicated tokens (`TlTokens.repeat`). `joint_future_pred` on tiny_config (HPTR, window
11), with use_pallas False at check_level 0 and with use_pallas True (dense_knn_max 16, as
`tests/test_torch_slice.py`: the map through B4's wrapper, the agent decoder through B2's) at check_level 1:
the K0 rows and, with the JAX-sampled latents and destinations injected, every row, at the tolerances of
`tests/torch_rnn_common.py`. The training step on this path is `tests/test_torch_rnn_train_hptr_tl.py`.
"""

import dataclasses

import pytest
import torch

from torch_rnn_common import K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows, run_joint_future
from trafficbotsv15_tpu.config import tiny_config

torch.set_num_threads(2)


def hptr_cfg(use_pallas: bool):
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True, tl_prepass=False)
    tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=use_pallas, dense_knn_max=16 if use_pallas else 128)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "pallas"])
def run(request):
    return run_joint_future(hptr_cfg(request.param), check_level=1 if request.param else 0)


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_hptr_in_rollout_tl_k0_rows(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_hptr_in_rollout_tl_injected_every_row(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_hptr_in_rollout_tl_injected_rule_flags(run):
    assert_flags(run["jroll"], run["injected"])


def test_hptr_in_rollout_tl_runs_no_pre_pass(monkeypatch):
    """tl_prepass=False: no pass before the rollout; the TL encoder runs once per rollout step on the
    K-replicated batch."""
    from test_torch_helpers import port_cfg
    from trafficbotsv15_tpu_torch.data.synthetic import make_batch
    from trafficbotsv15_tpu_torch.sim import tl_prepass
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    cfg = port_cfg(hptr_cfg(False))
    model = build_model(cfg, seed=0, device="cpu")
    monkeypatch.setattr(tl_prepass, "tl_rollout_scan", lambda *a, **kw: pytest.fail("the pre-pass ran"))
    seen = []
    real = model.tl_encoder.forward
    monkeypatch.setattr(model.tl_encoder, "forward", lambda *a, **kw: seen.append(a[0].shape[0]) or real(*a, **kw))
    port_eval.joint_future_pred(cfg, model, make_batch(cfg.data, n_sc=1, seed=0),
                                generator=torch.Generator().manual_seed(0), n_joint_future=2, device="cpu")
    assert seen == [2] * cfg.time_step_end

