#!/usr/bin/env python
"""Which float32 training step is off where the card and the CPU disagree on a gradient.

chip_smoke.py's card-vs-CPU training checks (phases 7 and 17 (a)) hold the card's float32 step
against the CPU's. Where they disagree, this script takes a third and a fourth witness: the CPU
in float64, and the CPU's float32 step with every weight moved by 1e-7 of itself. Each run's
loss terms and gradients are set against the float64 run of the same config (chip_smoke's
`grads_against`: relative loss / grad_norm error, worst gradient error over its scale). A
float32 run that lies far from float64 while its perturbed twin does not sits on a kink of
the loss, where rounding picks a side. Last it finds the kink: every `torch.relu` input of the
training forward on the CPU in float32 and in float64, and the elements whose sign differs.

Usage (the card's rows only where CUDA is available):

    python scripts/torch_grad_witness.py --batch-seed 0 [--navi-mode dest] [--repredict] \\
        [--steps 30] [--use-pallas both|true|false]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def witness(use_pallas: bool, args) -> None:
    cfg, batch, noise = cs.train_check_setup(use_pallas, args.steps, navi_mode=args.navi_mode,
                                             repredict=args.repredict, batch_seed=args.batch_seed)
    ref = cs.train_step_run(cfg, batch, noise, "cpu", float64=True)
    runs = [("CPU float32", cs.train_step_run(cfg, batch, noise, "cpu")),
            ("CPU float32, weights x (1 + 1e-7 N(0, 1))", cs.train_step_run(cfg, batch, noise, "cpu", perturb=1e-7)),
            ("CPU float64, weights x (1 + 1e-7 N(0, 1))",
             cs.train_step_run(cfg, batch, noise, "cpu", float64=True, perturb=1e-7))]
    if torch.cuda.is_available():
        runs.append((f"card float32 ({torch.cuda.get_device_name(0)})", cs.train_step_run(cfg, batch, noise, "cuda")))
    print(f"navi_mode={args.navi_mode} repredict={args.repredict} use_pallas={use_pallas} batch seed "
          f"{args.batch_seed}, {cfg.time_step_end} steps; against the CPU in float64 (loss "
          f"{ref[0]['training/loss']:.9f}, grad_norm {ref[0]['grad_norm']:.9f}):")
    for name, run in runs:
        loss_err, worst, worst_name, _ = cs.grads_against(run, ref)
        print(f"  {name}: loss terms / grad_norm within {loss_err:.3e} relative; gradients within {worst:.3e} of "
              f"their scale (worst {worst_name}; chip_smoke's tolerance {cs.TRAIN_GRAD_REL:g})")
    if torch.cuda.is_available():
        loss_err, worst, worst_name, _ = cs.grads_against(runs[-1][1], runs[0][1])
        print(f"  card against CPU float32: {loss_err:.3e}, {worst:.3e} (worst {worst_name})")


def relu_flips(use_pallas: bool, args) -> None:
    """The ReLU pre-activations of the training forward (pre-processing to loss) whose sign differs between the
    CPU's float32 and float64 runs: (call index, shape, element, float32 value, float64 value)."""
    cfg, batch, noise = cs.train_check_setup(use_pallas, args.steps, navi_mode=args.navi_mode,
                                             repredict=args.repredict, batch_seed=args.batch_seed)
    real = torch.relu
    seen = {}
    for float64 in (False, True):
        calls = seen[float64] = []

        def relu(x, calls=calls):
            calls.append(x.detach().double().clone())
            return real(x)

        model = cs.build_model(cfg, seed=1, device="cpu")
        cs.damp_weights(model, 0.5)
        dtype = torch.float64 if float64 else torch.float32
        model.to(dtype)
        dev_noise = {k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else
                     [t.to(dtype) for t in v] if k == "navi_noise" else v for k, v in noise.items()}
        torch.relu = relu
        try:
            with cs.cpu_float64() if float64 else contextlib.nullcontext(), torch.no_grad():
                cs.train_lib.training_forward(cfg, model, cs.train_lib.batch_to_device(batch, torch.device("cpu")),
                                              dev_noise)
        finally:
            torch.relu = real
    flips = []
    for i, (x32, x64) in enumerate(zip(seen[False], seen[True])):
        for j in ((x32 > 0) != (x64 > 0)).nonzero().tolist():
            flips.append((i, tuple(x32.shape), tuple(j), float(x32[tuple(j)]), float(x64[tuple(j)])))
    print(f"  ReLU inputs whose sign differs, CPU float32 against float64, of {len(seen[False])} relu calls: "
          f"{flips[:8] if flips else 'none'}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-seed", type=int, default=0)
    ap.add_argument("--navi-mode", default="dest")
    ap.add_argument("--repredict", action="store_true")
    ap.add_argument("--steps", type=int, default=None, help="rollout steps (default: the config's 30)")
    ap.add_argument("--use-pallas", default="true", choices=("both", "true", "false"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for use_pallas in {"both": (False, True), "true": (True,), "false": (False,)}[args.use_pallas]:
        witness(use_pallas, args)
        relu_flips(use_pallas, args)


if __name__ == "__main__":
    main()
