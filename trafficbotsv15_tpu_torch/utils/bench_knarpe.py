"""Microbench of the KNARPE cross-attention kernels against the library composition, on one GPU.

    python -m trafficbotsv15_tpu_torch.utils.bench_knarpe [--shape flagship|scaled] [--iters 50]

The port of `scripts/bench_knarpe.py`: the same shapes (flagship [128·64
sources, K=89, D=R=128, H=4]; scaled [128·64, K=89, D=R=256, H=8]), the same
operand distributions (normal bf16 operands, 20 %
of targets invalid, weights and bias times 0.05; drawn from a numpy seed,
since `jax.random` cannot be matched) and the same three variants:

  - `library_fullwidth`, the counterpart of the script's `xla_fullwidth`:
    one matmul of [tgt | rpe] by [W_kv; W_rpe] plus b, then the head
    attention by `scaled_dot_product_attention` (a yardstick; the port never
    calls it);
  - `knarpe_v2`: B2, `ops/knarpe.py::knarpe_cross_attention`;
  - `knarpe_v3`: B3, `ops/knarpe.py::knarpe_cross_attention_v3`.

For each it prints the time per call after 2 warm-ups (CUDA events over
`--iters` eager calls), the error relative to the library output (max |out -
ref| / max |ref|), the input-stream rate (tgt and rpe bytes over the time) and
the route the kernel launch took (`ops/knarpe.py::ROUTE_LAUNCHES`). The card's
name and power limit come first, one JSON line last. It runs on the card;
`run(..., device="cpu")` runs the plain versions on the CPU instead (timed by
the host clock, route "plain"); without a card and that request it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from trafficbotsv15_tpu_torch.ops import knarpe
from trafficbotsv15_tpu_torch.utils.device import resolve_device
from trafficbotsv15_tpu_torch.utils.timing import card_line, cuda_ms

# (n_b, n_s, K, D, R, H), as scripts/bench_knarpe.py:42-46
SHAPES = {"flagship": (128, 64, 89, 128, 128, 4), "scaled": (128, 64, 89, 256, 256, 8)}


def inputs(shape, device, seed: int = 0):
    """q, tgt, rpe, invalid, w_kv, w_rpe, b in bf16 (invalid bool) as the script draws them, from a numpy seed."""
    n_b, n_s, n_knn, d, r, _ = shape
    rng = np.random.default_rng(seed)

    def f(*size, scale=1.0):
        return torch.from_numpy((rng.normal(size=size) * scale).astype(np.float32)).to(device, torch.bfloat16)

    q, tgt, rpe = f(n_b, n_s, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, r)
    inv = torch.from_numpy(rng.uniform(size=(n_b, n_s, n_knn)) < 0.2).to(device)
    return q, tgt, rpe, inv, f(d, 2 * d, scale=0.05), f(r, 2 * d, scale=0.05), f(2 * d, scale=0.05)


def library_attention(q, k, v, invalid, n_head: int) -> torch.Tensor:
    """KNN attention of q [B, S, D] over k, v [B, S, K, D] by scaled_dot_product_attention, one call for every
    head, invalid [B, S, K] masked. -> [B, S, D]."""
    n_b, n_s, n_knn, d = k.shape
    dh = d // n_head

    def heads(t):  # [b, s, K, D] -> [b*s, H, K, dh]
        return t.reshape(n_b * n_s, n_knn, n_head, dh).transpose(1, 2)

    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(n_b * n_s, n_head, 1, dh), heads(k), heads(v), attn_mask=~invalid.reshape(n_b * n_s, 1, 1, n_knn))
    return out.reshape(n_b, n_s, d)


def library_fullwidth(q, tgt, rpe, invalid, w_kv, w_rpe, b, n_head: int) -> torch.Tensor:
    """One concat matmul for k and v, then `library_attention`. -> [B, S, D]."""
    k, v = (torch.cat([tgt, rpe], -1) @ torch.cat([w_kv, w_rpe], 0) + b).chunk(2, -1)
    return library_attention(q, k, v, invalid, n_head)


def time_ms(fn, device: torch.device, iters: int) -> float:
    """ms per call after 2 warm-ups: CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn, iters, warmup=2)
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def run(shape: str = "flagship", iters: int = 50, device=None) -> dict:
    """Time the three variants at SHAPES[shape], print a line each and the JSON line; -> the JSON object."""
    device = resolve_device(device)
    dims = SHAPES[shape]
    n_head = dims[-1]
    card = card_line() if device.type == "cuda" else "cpu (no card: the plain versions)"
    print(card, flush=True)
    args = inputs(dims, device)
    variants = [("library_fullwidth", library_fullwidth, None),
                ("knarpe_v2", knarpe.knarpe_cross_attention, "knarpe_cross_attention"),
                ("knarpe_v3", knarpe.knarpe_cross_attention_v3, "knarpe_cross_attention_v3")]
    ref = library_fullwidth(*args, n_head).float()
    bytes_in = (args[1].numel() + args[2].numel()) * 2  # the dominant device-memory reads per call
    rows = []
    for name, fn, kernel in variants:
        before = dict(knarpe.ROUTE_LAUNCHES)
        out = fn(*args, n_head).float()
        if kernel is None:
            way = "library"
        elif device.type == "cpu":
            way = "plain"
        else:
            way = "/".join(key.split("/")[1] for key, n in knarpe.ROUTE_LAUNCHES.items()
                           if key.split("/")[0] == kernel and n != before[key])
        err = float((out - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
        ms = time_ms(lambda: fn(*args, n_head), device, iters)
        row = {"variant": name, "ms": ms, "rel_err": err, "input_gb_per_s": bytes_in / ms / 1e6, "route": way}
        print(f"{name:18s} {ms:9.4f} ms   rel_err={err:.2e}   input-stream {row['input_gb_per_s']:.0f} GB/s   "
              f"route {way}", flush=True)
        rows.append(row)
    result = {"shape": shape, "dims": list(dims), "iters": iters, "device": card, "variants": rows}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="flagship", choices=sorted(SHAPES))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    run(args.shape, args.iters)


if __name__ == "__main__":
    main()
