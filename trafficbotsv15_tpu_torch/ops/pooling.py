"""Sequence pooling over the step/node axis (counterpart of `trafficbotsv15_tpu/ops/pooling.py`)."""

from __future__ import annotations

import torch

_NEG = -1e9  # large-negative fill; keeps -inf out of the max of all-invalid rows


def seq_pooling(x: torch.Tensor, invalid: torch.Tensor, mode: str) -> torch.Tensor:
    """Pool [n_sc, n, n_step, d] -> [n_sc, n, d] along axis 2; all-invalid rows are zeroed.

    mode: max_valid | first | last | last_valid | mean_valid (the valid steps' sum over their count + the
    dtype's eps, as the JAX package divides).
    """
    if mode == "max_valid":
        pooled = torch.where(invalid[..., None], _NEG, x).amax(dim=2)
    elif mode == "first":
        pooled = x[:, :, 0]
    elif mode == "last":
        pooled = x[:, :, -1]
    elif mode == "last_valid":
        n_step = invalid.shape[2]
        # first valid step of the reversed sequence == last valid step
        rev_first = torch.argmax((~invalid).flip(2).to(torch.uint8), dim=2)
        idx_last = n_step - 1 - rev_first
        pooled = torch.gather(x, 2, idx_last[:, :, None, None].expand(-1, -1, 1, x.shape[-1]))[:, :, 0]
    elif mode == "mean_valid":
        total = torch.where(invalid[..., None], 0.0, x).sum(dim=2)
        count = (~invalid).sum(dim=2, keepdim=True).to(x.dtype)
        pooled = total / (count + torch.finfo(x.dtype).eps)
    else:
        raise NotImplementedError(f"seq_pooling mode {mode!r}")
    all_invalid = invalid.all(dim=-1, keepdim=True)
    return torch.where(all_invalid, 0.0, pooled)
