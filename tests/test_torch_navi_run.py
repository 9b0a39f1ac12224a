"""PyTorch port: the navigation variants through the CLI (`run.py`) on the CPU: `model.navi_mode=goal|cmd|dummy|dest`,
`pred_navi_after_reached=true` and `model.add_navi_latent.mode=add|mul` go through `action=fit` (one step and one
validation batch), `action=validate` from "last" and `action=test` from "best" (one batch of 16 scenarios each; the
test split's history keys, K=32 futures): finite loss and metrics, the navi loss where there is a navi, the
checkpoint's config in the mode asked, and the submission's arrays of the expected shapes (without
`waymo_open_dataset`)."""

import json

import numpy as np
import pytest

from test_torch_helpers import set_threads
from trafficbotsv15_tpu_torch import run
from trafficbotsv15_tpu_torch.config import tiny_config

set_threads()

ARMS = {
    "goal-repredict-add": ["model.navi_mode=goal", "pred_navi_after_reached=true", "model.add_navi_latent.mode=add"],
    "cmd-mul": ["model.navi_mode=cmd", "model.add_navi_latent.mode=mul"],
    "dummy": ["model.navi_mode=dummy"],
    "dest-repredict": ["pred_navi_after_reached=true"],
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_navi_variant_fits_validates_and_submits(arm, tmp_path, monkeypatch):
    from trafficbotsv15_tpu_torch.eval import submission

    common = ["device=cpu", "preset=tiny", f"ckpt_dir={tmp_path}", "batch_size_test=16", *ARMS[arm]]
    model, _, stopped = run.main(["action=fit", "max_steps=1", "val_epoch_batches=1", *common])
    assert not stopped
    saved = json.loads((tmp_path / "last.json").read_text())["config"]
    for arg in ARMS[arm]:
        key, val = arg.split("=")
        node = saved
        for part in key.split("."):
            node = node[part]
        assert str(node).lower() == val, (key, node)
    metrics = run.main(["action=validate", *common])
    assert np.isfinite(metrics["val/loss"])
    assert ("reactive_replay/navi_loss" in metrics) == (arm != "dummy")

    def no_waymo(*args, **kwargs):
        raise ImportError("no waymo_open_dataset")

    monkeypatch.setattr(submission, "SubWOMD", no_waymo)
    result = run.main(["action=test", "n_joint_future_wosac=32", *common])
    cfg = tiny_config()
    n_fut = cfg.time_step_gt - cfg.time_step_current
    assert result and all(out["wosac_trajs"].shape == (16, 32, cfg.data.n_ag, n_fut, 3) for out in result)
    assert all(np.isfinite(out["wosac_trajs"]).all() for out in result)
