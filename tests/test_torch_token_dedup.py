"""PyTorch port: K-futures token dedup (`rollout_token_dedup`) on the CPU.

The dedup keeps one copy of the map and TL tokens per scenario, and each rollout step's map and TL selections and
gathers fold the K replicas into the agent axis (`sim/rollout.py`'s token_rep). Held here:
  - the port's dedup call against its replicated call on the same weights, batch and generator: every buffer tensor
    bit for bit (the JAX package's `tests/test_token_dedup.py` contract), in the pairwise model with use_pallas at
    dense_knn_max 4 (the B4 / B2 wrappers: the same calls by shape in both) and in the scene-centric one, in dest
    and goal mode, and the rollout really took token_rep = K;
  - the port's dedup call against JAX's dedup call (`tests/torch_navi_common.py::run_joint_future`, gain 0.5): the
    K0 rows, every row with JAX's draws injected, rule flags, at `tests/torch_rnn_common.py`'s tolerances;
  - the gate, JAX's (`train/evaluation.py::token_dedup_rep`): dedup where the TL pre-pass runs and
    `pred_navi_after_reached` is off; the replicated rollout without the pre-pass (`tl_prepass=False`, the RNN
    family) and with re-prediction, where the result is the replicated call's; the rollout's own checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import port_cfg, set_threads, t2n
from torch_navi_common import K, navi_cfg, run_joint_future
from torch_rnn_common import K0_FIELDS, ROW_FIELDS, assert_flags, assert_rows, count_wrappers, rnn_cfg
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.sim import rollout as port_rollout
from trafficbotsv15_tpu_torch.train import evaluation as port_eval
from trafficbotsv15_tpu_torch.train.pipeline import build_model

set_threads()
K_DEDUP = 3


def dedup_cfg(name: str, dedup: bool = True):
    """The JAX config of an arm: `pallas` (pairwise, dest, use_pallas), `scene_centric` (dest), `goal` (pairwise
    goal), `no_prepass` (tl_prepass off), `rnn`, `repredict` (goal re-predicting)."""
    if name == "pallas":
        cfg = navi_cfg("dest", use_pallas=True)
    elif name == "scene_centric":
        cfg = navi_cfg("dest")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pairwise_relative=False))
    elif name == "goal":
        cfg = navi_cfg("goal")
    elif name == "no_prepass":
        cfg = dataclasses.replace(navi_cfg("dest"), tl_prepass=False)
    elif name == "rnn":
        cfg = rnn_cfg()
    elif name == "repredict":
        cfg = navi_cfg("goal", repredict=True)
    else:
        raise ValueError(name)
    return dataclasses.replace(cfg, rollout_token_dedup=dedup)


def _port_call(cfg, monkeypatch, seed=0):
    """The port's joint_future_pred (K_DEDUP futures) -> (buffer, the rollout's token_rep, wrapper calls)."""
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, seed=0, device="cpu")
    seen = []
    real = port_rollout.rollout

    def spy(*a, **kw):
        seen.append(kw.get("token_rep", 1))
        return real(*a, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(port_rollout, "rollout", spy)
        calls = count_wrappers(mp)
        _, buf = port_eval.joint_future_pred(pcfg, model, make_batch(pcfg.data, n_sc=2, seed=seed),
                                             generator=torch.Generator().manual_seed(0), n_joint_future=K_DEDUP,
                                             device="cpu")
    return buf, seen[0], {k: sorted(v) for k, v in calls.items()}


def _assert_buffers_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert set(x) == set(y), f.name
            for k in x:
                assert torch.equal(x[k], y[k]), (f.name, k)
        elif x is None:
            assert y is None, f.name
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.parametrize("name", ["pallas", "scene_centric", "goal"])
def test_dedup_is_the_replicated_rollout_bit_for_bit(name, monkeypatch):
    dedup, rep_dedup, calls_dedup = _port_call(dedup_cfg(name), monkeypatch)
    plain, rep_plain, calls_plain = _port_call(dedup_cfg(name, dedup=False), monkeypatch)
    assert (rep_dedup, rep_plain) == (K_DEDUP, 1)
    _assert_buffers_equal(dedup, plain)
    assert calls_dedup == calls_plain  # the same kernel wrapper calls, by shape
    if name == "pallas":
        assert calls_dedup["knarpe_cross_attention"] and calls_dedup["knarpe_attention"]


@pytest.mark.parametrize("name,rep", [("no_prepass", 1), ("rnn", 1), ("repredict", 1), ("scene_centric", K_DEDUP)])
def test_the_gate_is_jaxs(name, rep, monkeypatch):
    """Without the TL pre-pass (tl_prepass off, the RNN family) or with pred_navi_after_reached the rollout
    replicates, as JAX's joint_future_pred does: token_rep 1 and the same result as without the flag."""
    buf, token_rep, _ = _port_call(dedup_cfg(name), monkeypatch)
    assert token_rep == rep
    if rep == 1:
        plain, _, _ = _port_call(dedup_cfg(name, dedup=False), monkeypatch)
        _assert_buffers_equal(buf, plain)


def test_the_rollout_checks_its_dedup_inputs():
    """token_rep must be the pre-pass's replication, with map tokens of the unique scenarios and no re-prediction."""
    pcfg = port_cfg(dedup_cfg("pallas"))
    model = build_model(pcfg, seed=0, device="cpu")
    batch = port_eval.batch_to_device(make_batch(pcfg.data, n_sc=2, seed=0), torch.device("cpu"))
    scene = port_eval.prepare_joint_future(pcfg, model, batch)
    port_rollout._check_token_rep(pcfg, K_DEDUP, K_DEDUP, scene.mp_tokens, 2 * K_DEDUP)
    with pytest.raises(ValueError, match="unique map batch"):
        port_rollout._check_token_rep(pcfg, K_DEDUP, K_DEDUP, scene.mp_tokens.repeat(2), 2 * K_DEDUP)
    with pytest.raises(ValueError, match="pre-pass"):
        port_rollout._check_token_rep(pcfg, K_DEDUP, 1, scene.mp_tokens, 2 * K_DEDUP)
    repredict = port_cfg(dedup_cfg("repredict"))
    with pytest.raises(ValueError, match="pred_navi_after_reached"):
        port_rollout._check_token_rep(repredict, K_DEDUP, K_DEDUP, scene.mp_tokens, 2 * K_DEDUP)


@pytest.fixture(scope="module", params=["pallas", "scene_centric"])
def run(request):
    return run_joint_future(dedup_cfg(request.param))


@pytest.mark.parametrize("field,atol", K0_FIELDS)
def test_dedup_k0_rows_match_jaxs_dedup_call(run, field, atol):
    assert_rows(run["jbuf"], run["pbuf"], field, atol, k0_only=True)


@pytest.mark.parametrize("field,atol", ROW_FIELDS)
def test_dedup_rollout_with_injected_samples_matches_jax(run, field, atol):
    assert_rows(run["jroll"], run["injected"], field, atol)


def test_dedup_rollout_rule_flags_match_jax(run):
    assert_flags(run["jroll"], run["injected"])
    assert_flags(run["jbuf"], run["pbuf"], k0_only=True)
    assert port_eval.token_dedup_rep(run["cfg"], _scene(run), K) == K
    assert np.isfinite(t2n(run["pbuf"].pred_pose)).all()


def _scene(run):
    batch = port_eval.batch_to_device(run["batch"], torch.device("cpu"))
    return port_eval.prepare_joint_future(run["cfg"], run["model"], batch)
