"""Model construction and seeded initialisation (counterpart of `build_model` in
`trafficbotsv15_tpu/train/pipeline.py`).

The compute dtype follows `cfg.precision` (bfloat16 compute with float32
parameters for the flagship, float32 for `tiny_config`). Training comes
with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from trafficbotsv15_tpu_torch.config import ExperimentCfg
from trafficbotsv15_tpu_torch.models.mlp import Dense
from trafficbotsv15_tpu_torch.models.traffic_bots import TrafficBots
from trafficbotsv15_tpu_torch.models.transformer import AttentionRPE
from trafficbotsv15_tpu_torch.utils.device import resolve_device


def compute_dtype(cfg: ExperimentCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bf16" else torch.float32


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic random weights from a CPU generator (device-independent):
    Dense weights normal(0, 1/fan_in), K/V and RPE projections Xavier-uniform,
    biases zero. LayerNorm and log_std parameters keep their construction values."""
    g = torch.Generator().manual_seed(seed)
    for _, module in sorted(model.named_modules(), key=lambda kv: kv[0]):
        if isinstance(module, Dense):
            fan_in = module.weight.shape[1]
            module.weight.copy_(torch.randn(module.weight.shape, generator=g) / math.sqrt(fan_in))
        elif isinstance(module, AttentionRPE):
            for w in (module.kv_w, getattr(module, "rpe_proj_w", None)):
                if w is not None:
                    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    w.copy_((torch.rand(w.shape, generator=g) * 2.0 - 1.0) * bound)


def build_model(cfg: ExperimentCfg, seed: Optional[int] = None, device=None) -> TrafficBots:
    """TrafficBots for cfg on `device` (CUDA unless device="cpu"), in eval mode.

    Weights are random from `seed` (default `cfg.seed`), the same values on
    any device; `load_state_dict` replaces them with trained ones.
    """
    device = resolve_device(device)
    model = TrafficBots(cfg.model, cfg.data, ops=cfg.ops, dtype=compute_dtype(cfg))
    init_weights(model, cfg.seed if seed is None else seed)
    return model.to(device).eval()
