"""PyTorch port: config mirror, import guard and device guards.

The port keeps its own copy of the config dataclasses; these tests hold the
copy to the JAX package field by field, check that nothing in the port (or
chip_smoke.py) imports JAX, flax or the JAX package, and that the entry
points and the kernel wrapper never carry on without the device they need.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trafficbotsv15_tpu import config as jax_config
from trafficbotsv15_tpu.ops.flags import OpsCfg as JaxOpsCfg
from trafficbotsv15_tpu_torch import config as port_config
from trafficbotsv15_tpu_torch.ops import knn
from trafficbotsv15_tpu_torch.ops.flags import OpsCfg, check_supported
from trafficbotsv15_tpu_torch.utils import build
from trafficbotsv15_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "trafficbotsv15_tpu_torch"
FORBIDDEN = ("jax", "flax", "trafficbotsv15_tpu")


@pytest.mark.parametrize("preset", ["leaderboard_config", "tiny_config", "scaled_config"])
def test_config_mirror_field_by_field(preset):
    ours = dataclasses.asdict(getattr(port_config, preset)())
    ref = dataclasses.asdict(getattr(jax_config, preset)())
    assert ours == ref


@pytest.mark.parametrize("use_pallas", [False, True])
def test_with_pallas_sets_only_the_flag(use_pallas):
    cfg = port_config.with_pallas(port_config.leaderboard_config(), use_pallas)
    assert cfg.model.tf_cfg.use_pallas is use_pallas
    ours = dataclasses.asdict(cfg)
    ref = dataclasses.asdict(port_config.leaderboard_config())
    ref["model"]["tf_cfg"]["use_pallas"] = use_pallas
    assert ours == ref


def test_ops_cfg_mirror():
    assert dataclasses.asdict(OpsCfg()) == dataclasses.asdict(JaxOpsCfg())


def test_ops_cfg_unsupported_selections_raise():
    check_supported(OpsCfg(knn_impl="sort"))
    for bad in (OpsCfg(approx_knn=True), OpsCfg(two_stage_knn=True)):
        with pytest.raises(NotImplementedError):
            check_supported(bad)


def _port_sources():
    """The port's modules, chip_smoke.py and the card-only tests (run without JAX via --noconftest)."""
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "tests").glob("test_torch_*_cuda.py"))


def test_source_scan_no_jax_imports():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|trafficbotsv15_tpu)\b", re.M)
    dyn = re.compile(r"import_module\(|__import__\(")
    offenders = []
    for path in _port_sources():
        text = path.read_text()
        if pat.search(text) or dyn.search(text):
            offenders.append(str(path.relative_to(REPO)))
    assert not offenders, offenders
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    assert len(scanned) > 20  # the scan actually saw the package
    assert scanned >= {"trafficbotsv15_tpu_torch/ops/knarpe.py", "trafficbotsv15_tpu_torch/sim/wosac_collision.py",
                       "trafficbotsv15_tpu_torch/sim/rule_checker.py", "tests/test_torch_knarpe_cuda.py",
                       "tests/test_torch_knn_cuda.py"}


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        + "assert not bad, bad\nprint(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_raise_without_cuda(monkeypatch):
    from trafficbotsv15_tpu_torch.eval import runner
    from trafficbotsv15_tpu_torch.train.evaluation import joint_future_pred, reactive_replay
    from trafficbotsv15_tpu_torch.train.pipeline import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.tiny_config()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg, device=device)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        joint_future_pred(cfg, model, {}, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reactive_replay(cfg, model, {})
    for entry in (lambda: runner.make_validate_step(cfg, model), lambda: runner.validate(cfg, model, []),
                  lambda: runner.test_submission(cfg, model, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert resolve_device("cpu").type == "cpu"

    from trafficbotsv15_tpu_torch import run

    loaders = run.make_dataloaders(cfg, "synthetic", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.fit(cfg, *loaders, ckpt_dir="unused")
    for action in ("fit", "validate", "test"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main([f"action={action}", "preset=tiny", "ckpt_dir=unused"])


def test_knn_wrapper_raises_off_cpu_without_kernel():
    src = torch.zeros(1, 8, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        knn.knn_xy(src, torch.zeros(1, 8, dtype=torch.bool, device="meta"),
                   torch.zeros(1, 512, 2, device="meta"), torch.zeros(1, 512, dtype=torch.bool, device="meta"), 4)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        knn.load_library()


def test_library_name_follows_source_and_flags(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// v1")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    base = build.library_path("k", "k.cu", ("--fmad=false",))
    assert base == build.library_path("k", "k.cu", ("--fmad=false",))
    assert base != build.library_path("k", "k.cu", ())
    (tmp_path / "k.cu").write_text("// v2")
    assert base != build.library_path("k", "k.cu", ("--fmad=false",))


def test_library_name_follows_included_headers(monkeypatch, tmp_path):
    """A header under csrc/ that the source includes, directly or through another header, is part
    of the hash: an edit to it once loaded the library built from the old header."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b v1")
    (tmp_path / "unused.cuh").write_text("// u v1")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.source_files("k.cu") == [tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh")]
    base = build.library_path("k", "k.cu")
    (tmp_path / "unused.cuh").write_text("// u v2")
    assert base == build.library_path("k", "k.cu")
    (tmp_path / "b.cuh").write_text("// b v2")
    assert base != build.library_path("k", "k.cu")


def test_knarpe_library_hash_covers_its_staged_header():
    assert build.CSRC_DIR / "knarpe_staged.cuh" in build.source_files("knarpe.cu")


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.uniform(-50, 50, (2, 8, 2)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(-50, 50, (2, 512, 2)).astype(np.float32))
    inv_s, inv_t = torch.zeros(2, 8, dtype=torch.bool), torch.zeros(2, 512, dtype=torch.bool)
    before = knn.LAUNCHES
    d, i = knn.knn_xy(src, inv_s, tgt, inv_t, 16)
    dr, ir = knn.knn_xy_reference(src, inv_s, tgt, inv_t, 16)
    assert knn.LAUNCHES == before
    assert torch.equal(d, dr) and torch.equal(i, ir)
