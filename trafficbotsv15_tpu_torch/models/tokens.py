"""Token containers passed between encoders (counterpart of `trafficbotsv15_tpu/models/tokens.py`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _rep(x, k: int):
    return None if x is None else torch.repeat_interleave(x, k, dim=0)


@dataclasses.dataclass
class MapTokens:
    """Static per-scenario map polyline tokens."""

    invalid: torch.Tensor  # [n_sc, n_mp] bool
    feature: torch.Tensor  # [n_sc, n_mp, hidden_dim]
    pose: torch.Tensor  # [n_sc, n_mp, 3]
    type: torch.Tensor  # [n_sc, n_mp, n_mp_type] bool one-hot

    def repeat(self, k: int) -> "MapTokens":
        """Each scenario k times along the scenario axis (the K joint futures)."""
        return MapTokens(_rep(self.invalid, k), _rep(self.feature, k), _rep(self.pose, k), _rep(self.type, k))


@dataclasses.dataclass
class TlTokens:
    """Static traffic-light tokens + precomputed KNN/RPE and per-layer static K/V."""

    valid: torch.Tensor  # [n_sc, n_tl] bool
    invalid: torch.Tensor  # [n_sc, n_tl] bool
    pose: torch.Tensor  # [n_sc, n_tl, 3]
    attr: Optional[torch.Tensor] = None  # [n_sc, n_tl, hidden_dim] (lane mode)
    knn_idx_tl2tl: Optional[torch.Tensor] = None  # [n_sc, n_tl, K_tl2tl]
    knn_invalid_tl2tl: Optional[torch.Tensor] = None
    rpe_tl2tl: Optional[torch.Tensor] = None  # [n_sc, n_tl, K_tl2tl, d_rpe]
    knn_tgt_tl2mp: Optional[torch.Tensor] = None  # [n_sc, n_tl, K_tl2mp, hidden_dim]
    knn_invalid_tl2mp: Optional[torch.Tensor] = None
    rpe_tl2mp: Optional[torch.Tensor] = None
    # per layer of tf_tl2tlmp: ((k + rpe_k, v + rpe_v) of the map targets, decoder (rpe_k, rpe_v))
    static_kv: Optional[tuple] = None

    def repeat(self, k: int) -> "TlTokens":
        """Every field, each scenario k times: the rollout that runs the TL encoder in its steps reads them all."""
        def rep(x):
            if isinstance(x, (tuple, list)):
                return type(x)(rep(v) for v in x)
            return _rep(x, k)

        return TlTokens(**{f.name: rep(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def repeat_for_rollout(self, k: int) -> "TlTokens":
        """The fields the rollout reads (validity and pose), each scenario k times.

        With the TL pre-pass the replicated rollout never runs the TL
        encoder, so the encoder-only fields are not replicated."""
        return TlTokens(valid=_rep(self.valid, k), invalid=_rep(self.invalid, k), pose=_rep(self.pose, k))
