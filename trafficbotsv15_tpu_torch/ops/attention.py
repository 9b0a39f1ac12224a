"""KNARPE attention core math (counterpart of `trafficbotsv15_tpu/ops/attention.py`).

Layouts (as in the JAX package):
  - dense:    k, v [n_b, n_tgt, n_head, d_head]
  - per-src:  k, v [n_b, n_src, n_knn, n_head, d_head] (KNN-gathered), optional
    rpe_k / rpe_v of the same layout
  - full-width per-src: k, v [n_b, n_src, n_knn, d_model] (heads not split).
A row whose targets are all invalid gets a zero output and no NaN.
`attn_drop`, where given, is applied to the softmax weights before they
weigh the values (`attn_dropout_weights`, the reference's placement).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_MASK_VALUE = -1e9


def _masked_softmax(logits: torch.Tensor, invalid: Optional[torch.Tensor]):
    """Softmax over the last axis with a bool invalid mask (broadcast).

    Returns (attn, no_valid) where no_valid [..] marks rows with no valid target.
    """
    if invalid is None:
        return torch.softmax(logits, -1), None
    logits = torch.where(invalid, _MASK_VALUE, logits)
    m = logits.amax(-1, keepdim=True)
    e = torch.where(invalid, 0.0, torch.exp(logits - m))
    denom = e.sum(-1, keepdim=True)
    no_valid = denom <= 0.0
    attn = e / torch.where(no_valid, 1.0, denom)
    return attn, no_valid[..., 0]


def _dropped(attn: torch.Tensor, attn_drop) -> torch.Tensor:
    return attn if attn_drop is None else attn_drop(attn)


def dense_attention(q, k, v, invalid: Optional[torch.Tensor], attn_drop=None):
    """Standard MHA. q [b, s, h, d], k/v [b, t, h, d], invalid [b, s, t] -> out [b, s, h*d]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    inv = None if invalid is None else invalid[:, None, :, :]
    attn, no_valid = _masked_softmax(logits, inv)
    attn = _dropped(attn, attn_drop)
    out = torch.einsum("bhst,bthd->bshd", attn, v)
    if no_valid is not None:
        out = torch.where(no_valid.transpose(1, 2)[..., None], 0.0, out)
    return out.reshape(q.shape[0], q.shape[1], -1)


def knn_attention_fullwidth(q, kf, vf, invalid: Optional[torch.Tensor], n_head: int, attn_drop=None) -> torch.Tensor:
    """Attention over full-width per-source K/V.

    q [b, s, D], kf/vf [b, s, K, D] (k + rpe_k, v + rpe_v), invalid [b, s, K]
    -> [b, s, D]. Per-head logits are reduced in float32, as in the JAX package.
    """
    n_b, n_src, n_knn, d_model = kf.shape
    d_head = d_model // n_head
    scale = 1.0 / math.sqrt(d_head)
    prod = (q[:, :, None, :] * kf).float().reshape(n_b, n_src, n_knn, n_head, d_head)
    logits = prod.sum(-1).transpose(2, 3) * scale  # [b, s, h, K]
    inv = None if invalid is None else invalid[:, :, None, :]
    attn, no_valid = _masked_softmax(logits, inv)
    attn = _dropped(attn, attn_drop)
    out = torch.einsum("bshk,bskhd->bshd", attn.to(q.dtype), vf.reshape(n_b, n_src, n_knn, n_head, d_head))
    if no_valid is not None:
        out = torch.where(no_valid[..., None], 0.0, out)
    return out.reshape(n_b, n_src, d_model)


def knn_attention(q, k, v, invalid: Optional[torch.Tensor], rpe_k=None, rpe_v=None, rpe_q=None,
                  attn_drop=None) -> torch.Tensor:
    """KNN/RPE attention with per-source gathered targets: logits (q [+ rpe_q])·(k [+ rpe_k]) / sqrt(d).

    q [b, s, h, d], k/v (and rpe_q/rpe_k/rpe_v) [b, s, K, h, d], invalid [b, s, K] -> [b, s, h*d].
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    if rpe_k is not None:
        k = k + rpe_k
    qx = q[:, :, None]
    if rpe_q is not None:
        qx = qx + rpe_q
    logits = torch.sum(qx * k, -1).transpose(2, 3) * scale  # [b, s, h, K]
    inv = None if invalid is None else invalid[:, :, None, :]
    attn, no_valid = _masked_softmax(logits, inv)
    attn = _dropped(attn, attn_drop)
    if rpe_v is not None:
        v = v + rpe_v
    out = torch.einsum("bshk,bskhd->bshd", attn, v)
    if no_valid is not None:
        out = torch.where(no_valid[..., None], 0.0, out)
    return out.reshape(q.shape[0], q.shape[1], -1)
