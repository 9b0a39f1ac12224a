"""PyTorch port: a JAX package checkpoint carried into the port.

The JAX package's own `CheckpointManager` writes a "last" checkpoint in the layout its fit writes: the params tree
(from JAX's `init_params` on the first batch of JAX `run.py`'s synthetic loader, `PRNGKey(cfg.seed)`, as its fit
initialises them) with the optimizer state, and `last.json` with the config. (`tests/test_runner_ckpt.py` covers a
JAX fit writing such a checkpoint; no training step is compiled here.) Its "last" is restored to numpy with the JAX
package's manager, loaded into the port (`utils/jax_import.py`) with the port's `config_from_dict` of its
`last.json`, saved with the port's manager; `python -m trafficbotsv15_tpu_torch.run action=validate device=cpu`
then gives the JAX `validate`'s val/loss on those parameters within 1e-4 relative (float32 reactive replay over 20
steps, reduction order only). Every weight matrix of the tree is scaled by 0.5 on both sides first: at the JAX
initialiser's gain of 1 the random closed loop is chaotic
(`test_torch_slice.py::test_damped_random_policy_is_not_chaotic`).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_helpers import jax_sort_knn, set_threads
from trafficbotsv15_tpu import config as jax_config
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu_torch import config as port_config
from trafficbotsv15_tpu_torch.train.checkpoint import CheckpointManager

set_threads()
REPO = Path(__file__).resolve().parent.parent


def test_jax_checkpoint_migrates_into_the_port(tmp_path):
    from trafficbotsv15_tpu import run as jax_run
    from trafficbotsv15_tpu.eval import runner as jax_runner
    from trafficbotsv15_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from trafficbotsv15_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from trafficbotsv15_tpu.train.pipeline import build_model as jax_build_model
    from trafficbotsv15_tpu.train.pipeline import init_params
    from trafficbotsv15_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
    from trafficbotsv15_tpu_torch.train.pipeline import build_model
    from trafficbotsv15_tpu_torch.utils.jax_import import load_jax_params

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    common = ["preset=tiny", "data=synthetic", "batch_size_test=4"]
    # what JAX's `run.main action=fit batch_size_train=1 validate_every_epoch=false` builds before its first step
    jcfg = jax_run.apply_overrides(jax_config.tiny_config(), {"batch_size_train": 1, "batch_size_test": 4,
                                                              "validate_every_epoch": False})
    train_loader, _ = jax_run.make_dataloaders(jcfg, "synthetic", None)
    first = {k: jnp.asarray(v) for k, v in next(iter(train_loader)).items() if not isinstance(v, list)}
    model = jax_build_model(jcfg)
    with jax_sort_knn():  # jitted: the same values as eager, in a quarter of its time on the CPU
        params = jax.jit(lambda key: init_params(jcfg, model, first, key))(jax.random.PRNGKey(jcfg.seed))
    opt = jax_make_optimizer(jcfg.optimizer, steps_per_epoch=len(train_loader))
    jax_ckpt = JaxCheckpointManager(str(jax_dir))
    jax_ckpt.save_last({"params": params, "opt_state": opt.init(params)}, jcfg, {"step": 0, "epoch": 0})
    jax_ckpt.wait()

    state, _, meta = JaxCheckpointManager(str(jax_dir)).restore("last")
    assert meta["step"] == 0 and set(state) == {"params", "opt_state"}
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x) * (0.5 if np.ndim(x) == 2 else 1.0), state["params"])
    cfg = port_config.config_from_dict(json.loads((jax_dir / "last.json").read_text())["config"])
    model = build_model(cfg, device="cpu")
    load_jax_params(model, tree)
    mgr = CheckpointManager(str(port_dir))
    mgr.save_last({"model": model.state_dict()}, cfg, meta)
    mgr.wait()

    # the port's validate runs in its own process while JAX's runs here
    log = open(tmp_path / "port_validate.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "trafficbotsv15_tpu_torch.run", "action=validate", "device=cpu",
                             f"ckpt_dir={port_dir}", *common], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        # the port's validation batches on one device: 4 batches of 4 scenarios, batch i from seed 10000 + i
        vcfg = jax_run.apply_overrides(jax_config.tiny_config(), {"batch_size_test": 4})
        val_loader = [make_batch(vcfg.data, n_sc=4, seed=10_000 + i) for i in range(4)]
        with jax_sort_knn():
            want = jax_runner.validate(vcfg, val_loader, params=jax.tree_util.tree_map(jnp.asarray, tree),
                                       logger=JaxMetricsLogger(None, echo=False))["val/loss"]
        proc.wait(timeout=600)
    finally:
        proc.kill()
        proc.wait()
        log.close()
    assert proc.returncode == 0, (tmp_path / "port_validate.log").read_text()[-3000:]
    got = json.loads((port_dir / "metrics.jsonl").read_text().splitlines()[-1])["val/loss"]
    assert abs(got - want) <= 1e-4 * max(abs(want), 1.0), (got, want)
