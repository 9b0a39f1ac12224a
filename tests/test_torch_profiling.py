"""The port's profiling (`trafficbotsv15_tpu_torch/utils/profiling.py`) and its `run.py` keys, on the CPU.

`trace` writes a Chrome trace holding the `annotate` ranges; `StepTimer` keeps JAX's means under a patched clock;
`run.main` fit with `profile_dir` traces exactly steps 3-5, as JAX's fit does, and writes the trace when the fit ends
inside those steps too (JAX's stays open: a divergence); `debug_nans=true` runs the action under anomaly mode with NaN
checks and restores the mode after it (JAX's flag stays on); `rbg` still raises.
"""

import time

import pytest
import torch

from test_torch_helpers import set_threads
from trafficbotsv15_tpu.utils import profiling as jax_profiling
from trafficbotsv15_tpu_torch import run as run_lib
from trafficbotsv15_tpu_torch.utils import profiling

set_threads()

# a tiny fit with a 12-step horizon: 2 steps past the history, every part of a training step
FIT = ["action=fit", "device=cpu", "preset=tiny", "data.n_step=13", "time_step_end=12", "time_step_gt=12",
       "validate_every_epoch=false", "log_every=1000"]


def fit_step_ranges(path) -> dict:
    events = profiling.read_trace(path)
    return {i: len(profiling.annotation_windows(events, f"fit step {i}")) for i in range(8)}


def test_trace_writes_the_annotate_ranges(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as path:
        with profiling.annotate("outer"):
            x = torch.randn(64, 64)
            for _ in range(3):
                with profiling.annotate("inner"):
                    x = torch.tanh(x @ x)
    assert path == tmp_path / "rank0.pt.trace.json.gz" and path.stat().st_size > 0
    events = profiling.read_trace(path)
    outer, inner = profiling.annotation_windows(events, "outer"), profiling.annotation_windows(events, "inner")
    assert len(outer) == 1 and len(inner) == 3
    assert all(outer[0][0] <= a <= b <= outer[0][1] for a, b in inner)
    assert any(e.get("name") == "aten::mm" for e in events)
    assert profiling.kernel_events(events) == [] and profiling.device_intervals(events) == []  # no device traced


def test_trace_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without a device the trace is the card's (CPU and CUDA activity); without a card that raises, as every entry
    point of the port does; device="cpu" traces the CPU alone."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    if torch.cuda.is_available():
        assert cuda in profiling.Tracer(str(tmp_path)).profiler.activities
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.Tracer(str(tmp_path))
    assert cuda not in profiling.Tracer(str(tmp_path), device="cpu").profiler.activities


def test_busy_seconds_merges_overlapping_device_intervals():
    events = [{"cat": "kernel", "ts": 0, "dur": 10}, {"cat": "gpu_memcpy", "ts": 5, "dur": 10},
              {"cat": "kernel", "ts": 30, "dur": 10}, {"cat": "cpu_op", "ts": 0, "dur": 100}]
    assert profiling.device_intervals(events) == [(0.0, 15.0), (30.0, 40.0)]
    assert profiling.busy_seconds(profiling.device_intervals(events), 10.0, 35.0) == pytest.approx(10e-6)


def test_step_timer_means_equal_jax(monkeypatch):
    ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 4.0, 8.0, 8.0, 8.25, 9.0, 9.5, 10.0, 13.0, 13.0, 13.5] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    means = []
    for module in (profiling, jax_profiling):
        timer = module.StepTimer(warmup=1)
        for name in ("encode", "rollout", "encode", "rollout", "encode", "rollout", "encode", "metrics"):
            with timer.phase(name):
                pass
        means.append(timer.means())
    assert means[0] == means[1] == {"encode": (0.5 + 0.25 + 3.0) / 3, "rollout": (4.0 + 0.5) / 2, "metrics": 0.0}


def test_fit_with_profile_dir_traces_steps_3_to_5(tmp_path, capsys):
    run_lib.main(FIT + [f"ckpt_dir={tmp_path / 'ck'}", "max_steps=6", f"profile_dir={tmp_path / 'prof'}"])
    path = tmp_path / "prof" / "rank0.pt.trace.json.gz"
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [path.name]
    assert fit_step_ranges(path) == {0: 0, 1: 0, 2: 0, 3: 1, 4: 1, 5: 1, 6: 0, 7: 0}
    assert "trace of fit steps 3-5 written" in capsys.readouterr().out


def test_a_fit_ending_inside_the_traced_steps_still_writes_its_trace(tmp_path, monkeypatch):
    """max_steps=4 ends the fit after step 3: the trace holds step 3 and is written (JAX's stays open); a fit resumed
    past step 3 traces nothing, as JAX's."""
    calls = []

    def cheap_train_step(cfg, model, opt, schedule, device=None, sharded=None):  # the loop's trace handling only
        def step(batch, generator, epoch):
            calls.append(generator.initial_seed())
            return {"training/loss": torch.tensor(float(len(calls)))}
        step.accumulator = None
        return step

    monkeypatch.setattr(run_lib, "make_train_step", cheap_train_step)
    run_lib.main(FIT + [f"ckpt_dir={tmp_path / 'ck'}", "max_steps=4", f"profile_dir={tmp_path / 'prof'}"])
    path = tmp_path / "prof" / "rank0.pt.trace.json.gz"
    assert len(calls) == 4 and fit_step_ranges(path) == {0: 0, 1: 0, 2: 0, 3: 1, 4: 0, 5: 0, 6: 0, 7: 0}

    run_lib.main(FIT + [f"ckpt_dir={tmp_path / 'ck'}", "max_steps=6", "resume=true",
                        f"profile_dir={tmp_path / 'resumed'}"])
    assert len(calls) == 6 and not (tmp_path / "resumed").exists()


def test_debug_nans_runs_the_action_under_anomaly_mode(tmp_path, monkeypatch):
    """One real fit step under anomaly mode; the mode before it is back after it, and a fit without the key runs
    without it (its fit a stub)."""
    seen, real_fit = [], run_lib.fit

    def spy(*args, **kwargs):
        seen.append((torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()))
        return real_fit(*args, **kwargs) if len(seen) == 1 else (None, None, False)

    monkeypatch.setattr(run_lib, "fit", spy)
    before = torch.is_anomaly_enabled()
    try:
        _, logger, stopped = run_lib.main(FIT + [f"ckpt_dir={tmp_path}", "max_steps=1", "debug_nans=true"])
        assert seen == [(True, True)] and not stopped
        assert torch.is_anomaly_enabled() == before  # restored: this test's worker runs other tests after it
        run_lib.main(FIT + [f"ckpt_dir={tmp_path / 'plain'}", "max_steps=1"])
        assert seen[1] == (before, torch.is_anomaly_check_nan_enabled())
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_anomaly_mode_names_the_forward_op_of_a_nan_gradient():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with profiling.nan_checks(True), pytest.raises(RuntimeError, match="SqrtBackward0"):
        torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    with profiling.nan_checks(False):
        assert not torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_checks(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("args,error,match", [
    (["action=fit", "rbg=true"], NotImplementedError, "JAX"),
    (["action=validate", "profile_dir=/nonexistent/p"], ValueError, "profile_dir belongs to action=fit"),
    (["action=test", "video_dir=/nonexistent/v"], ValueError, "video_dir belongs to action=validate"),
])
def test_keys_refused_before_any_work(tmp_path, args, error, match):
    with pytest.raises(error, match=match):
        run_lib.main(args + ["device=cpu", "preset=tiny", f"ckpt_dir={tmp_path}", "max_steps=1"])
    assert not list(tmp_path.iterdir())
