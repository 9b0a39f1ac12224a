"""Shared set-up of the parity tests of the categorical latents and the input, TL and pose variants
(tests/test_torch_latent_cat*.py, tests/test_torch_variants*.py): the configs, and the JAX package's
`joint_future_pred` run once under `jax.jit` with its rollout's draws captured beside the port's, as
`tests/torch_navi_common.py` runs it, with two hooks for a port model that differs from JAX's in layout only.

The configs are `tiny_config()` with deterministic K0 futures and one variant each:
  - `cat` / `std_cat`: a `cat` posterior (type-branched where said) and a `cat` or `std_cat` prior of n_cat = 2
    factors over tiny_config's latent_dim 4 (2 classes each);
  - `stop`: TL tokens at stop lines (`tl_mode="stop"`);
  - `stacked`: the stacked-input TL encoder (`temp_stack_input`);
  - `input`: InputEncoder mode `input` in the map, TL and agent encoders;
  - `pe_xy_dir`, `xy_dir`: the relative-pose RPE in those modes; `xy_dir` with use_pallas at dense_knn_max 4, so
    the map and agent self-attentions take B4's wrapper and the KNN cross-attentions B2's, all at d_rpe = 4;
  - `q_rpe`: `apply_q_rpe`. JAX runs it in its attention and blocks, but its model fails on it (its TL encoder
    hoists static K/V, which asserts `not apply_q_rpe`). So the whole-model runs hold the port's `apply_q_rpe`
    model with rpe_proj = [0; W_k; W_v] (query rows and bias zero, `q_rpe_state`) against JAX's model without it
    on W: rpe_q = 0 gives the same attention, by another path (no dense-KNN form, no hoisted K/V, no kernel).
Weights are random at gain 0.5 (`tests/test_torch_slice.py`). `xy_dir` feeds raw metres to the RPE projection:
there the closed loop amplifies float32 rounding past the tolerances, so its tests scale every rpe_proj_w by 1/100
(`scale_rpe`), to the pe modes' order of magnitude. Tolerances are `tests/torch_rnn_common.py`'s.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_helpers import jax_model_params, jax_sort_knn, port_cfg, port_model, to_jnp
from torch_navi_common import K, SAMPLES, _batch, _captured_call, _noise
from trafficbotsv15_tpu.config import DistEncoderCfg, InputEncoderCfg, PoseEmbCfg, tiny_config
from trafficbotsv15_tpu.train import evaluation as jax_eval

VARIANTS = ("stop", "stacked", "input", "pe_xy_dir", "xy_dir", "q_rpe")
N_CAT = 2


def cat_cfg(prior: str = "cat", branch_type: bool = True, free_nats=None):
    """tiny_config with a `cat` posterior (type-branched where branch_type) and a `cat` or `std_cat` prior; the KL's
    free nats set where given."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    m = cfg.model
    le = dataclasses.replace(m.latent_encoder,
                             latent_post=DistEncoderCfg(dist_type="cat", branch_type=branch_type, n_cat=N_CAT),
                             latent_prior=DistEncoderCfg(dist_type=prior, n_cat=N_CAT))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(m, latent_encoder=le))
    if free_nats is not None:
        cfg = dataclasses.replace(cfg, training_metrics=dataclasses.replace(cfg.training_metrics,
                                                                            kl_free_nats=free_nats))
    return cfg


def variant_cfg(name: str, jax_side: bool = False):
    """tiny_config in one group-2 variant (see the module docstring). For `q_rpe`, jax_side gives the config JAX
    runs (without apply_q_rpe)."""
    cfg = dataclasses.replace(tiny_config(), joint_future_pred_deterministic_k0=True)
    m = cfg.model
    if name == "stop":
        m = dataclasses.replace(m, tl_mode="stop")
    elif name == "stacked":
        m = dataclasses.replace(m, tl_encoder=dataclasses.replace(m.tl_encoder, temp_stack_input=True))
    elif name == "input":
        m = dataclasses.replace(
            m, mp_encoder=dataclasses.replace(m.mp_encoder, input_encoder=InputEncoderCfg(mode="input", n_layer=2)),
            tl_encoder=dataclasses.replace(m.tl_encoder, input_encoder=InputEncoderCfg(mode="input")),
            ag_encoder=dataclasses.replace(m.ag_encoder, input_encoder=InputEncoderCfg(mode="input")))
    elif name == "pe_xy_dir":
        m = dataclasses.replace(m, pose_rpe=PoseEmbCfg(mode="pe_xy_dir"))
    elif name == "xy_dir":
        m = dataclasses.replace(m, pose_rpe=PoseEmbCfg(mode="xy_dir"),
                                tf_cfg=dataclasses.replace(m.tf_cfg, use_pallas=True, dense_knn_max=4))
    elif name == "q_rpe":
        m = dataclasses.replace(m, tf_cfg=dataclasses.replace(m.tf_cfg, apply_q_rpe=not jax_side))
    else:
        raise ValueError(name)
    return dataclasses.replace(cfg, model=m)


def scale_rpe(tree, factor: float = 0.01):
    """The flax tree with every rpe_proj_w scaled by factor."""
    def edit(path, leaf):
        return leaf * np.float32(factor) if path[-1].key == "rpe_proj_w" else leaf

    return jax.tree_util.tree_map_with_path(edit, tree)


def q_rpe_state(state: dict, d_model: int) -> dict:
    """A port state_dict of the model without apply_q_rpe -> the apply_q_rpe model's: each attention's
    rpe_proj_w [d_rpe, 2d] and rpe_proj_b [2d] become rpe_proj.weight [3d, d_rpe] = [0; W.T] and rpe_proj.bias
    [3d] = [0; b], so rpe_q is 0 and (rpe_k, rpe_v) are the same."""
    out = {}
    for key, val in state.items():
        if key.endswith(".rpe_proj_w"):
            head = key[:-len("rpe_proj_w")]
            out[head + "rpe_proj.weight"] = torch.cat([torch.zeros(d_model, val.shape[0]), val.t()], 0)
        elif key.endswith(".rpe_proj_b"):
            out[key[:-len("rpe_proj_b")] + "rpe_proj.bias"] = torch.cat([torch.zeros(d_model), val])
        else:
            out[key] = val
    return out


def prepare(name: str):
    """(JAX cfg, port cfg, flax tree, port model) of a variant at gain 0.5 (see the module docstring)."""
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

    jcfg, pcfg_j = variant_cfg(name, jax_side=True), variant_cfg(name)
    _, tree = jax_model_params(jcfg, seed=0, gain=0.5)
    if name == "xy_dir":
        tree = scale_rpe(tree)
    if name != "q_rpe":
        return jcfg, port_cfg(pcfg_j), tree, port_model(jcfg, tree)
    pcfg = port_cfg(pcfg_j)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(q_rpe_state(params_from_jax(tree), pcfg.model.hidden_dim), strict=True)
    return jcfg, pcfg, tree, model


def run_joint_future(jcfg, pcfg, tree, pmodel, check_level: int = 1, batch_seed: int = 1):
    """JAX's joint_future_pred (jcfg) and the port's (pcfg, pmodel) on one batch; the port's K-future rollout again
    with JAX's latent and navi draws injected (`tests/torch_navi_common.py::run_joint_future`)."""
    from trafficbotsv15_tpu_torch.train import evaluation as port_eval

    jmodel, _ = jax_model_params(jcfg, seed=0, gain=0.5)
    batch = _batch(jcfg, batch_seed)
    key = jax.random.PRNGKey(0)

    def jfn(params, b):
        return jax_eval.joint_future_pred(jcfg, jmodel, params, b, key, n_joint_future=K, check_level=check_level)[1]

    with jax_sort_knn():
        jbuf, captured = jax.jit(_captured_call(jfn))(to_jnp(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    _, pbuf = port_eval.joint_future_pred(pcfg, pmodel, batch, generator=torch.Generator().manual_seed(0),
                                          n_joint_future=K, check_level=check_level, device="cpu")
    batch_t = port_eval.batch_to_device(batch, torch.device("cpu"))
    scene = port_eval.prepare_joint_future(pcfg, pmodel, batch_t)
    samples = {k: None if captured[k] is None else torch.from_numpy(np.array(captured[k])) for k in SAMPLES}
    k_roll = jax.random.split(key, 4)[3]
    injected = port_eval.rollout_joint_futures(pcfg, pmodel, batch_t, scene, K, check_level=check_level,
                                               navi_noise=_noise(jcfg, k_roll, 2 * K, batch), **samples)
    return dict(cfg=pcfg, model=pmodel, batch=batch, scene=scene, jbuf=jbuf, pbuf=pbuf, jroll=captured["buffer"],
                injected=injected, samples=samples, key=key)


def train_parity(name: str):
    """`tests/test_torch_helpers.py::train_step_parity` of a variant with every dropout rate at 0 (xy_dir on the
    scaled RPE projection; q_rpe's port model built by `prepare`). For q_rpe, JAX's rpe_proj_w / rpe_proj_b
    gradients come back under the port's names as the k and v rows of rpe_proj ([2d, d_rpe], [2d]): the query
    rows have no JAX counterpart (`q_rows`), and the port's grad_norm is taken without them."""
    from test_torch_helpers import no_dropout, train_step_parity
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    jcfg = no_dropout(variant_cfg(name, jax_side=True))
    if name == "xy_dir":
        return train_step_parity(jcfg, edit_tree=scale_rpe)
    if name != "q_rpe":
        return train_step_parity(jcfg)
    from trafficbotsv15_tpu_torch.utils.jax_import import params_from_jax

    pcfg = port_cfg(no_dropout(variant_cfg(name)))

    def to_port(tree):
        model = build_model(pcfg, device="cpu")
        model.load_state_dict(q_rpe_state(params_from_jax(tree), pcfg.model.hidden_dim), strict=True)
        return pcfg, model

    run = train_step_parity(jcfg, to_port=to_port)
    d = pcfg.model.hidden_dim
    grads = {}
    for key, g in run["jax_grads"].items():
        if key.endswith(".rpe_proj_w"):
            grads[key[:-len("rpe_proj_w")] + "rpe_proj.weight"] = g.t()
        elif key.endswith(".rpe_proj_b"):
            grads[key[:-len("rpe_proj_b")] + "rpe_proj.bias"] = g
        else:
            grads[key] = g
    port = dict(run["port_grads"])
    run["q_rows"] = {k: v[:d] for k, v in port.items() if ".rpe_proj." in k}
    run["port_grads"] = {k: v[d:] if ".rpe_proj." in k else v for k, v in port.items()}
    run["jax_grads"] = grads
    # the port's grad_norm counts the query rows too: without them it is the norm JAX's gradients have
    q_sq = sum(float((g.double() ** 2).sum()) for g in run["q_rows"].values())
    run["port_metrics"] = dict(run["port_metrics"], grad_norm=(run["port_metrics"]["grad_norm"] ** 2 - q_sq) ** 0.5)
    return run
