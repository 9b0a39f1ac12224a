"""KNARPE attention and pre-LN transformer blocks (counterpart of `trafficbotsv15_tpu/models/transformer.py`).

`AttentionRPE` keeps the branches the joint-future path takes:
  - dense-KNN: KNN self-attention over at most `dense_knn_max` tokens,
    computed as dense attention masked to the KNN slots (agent->agent,
    TL->TL, and the map at test sizes);
  - project-then-gather: KNN self-attention over larger token sets (the
    map's 1024 polylines): project the tokens once, then gather K/V;
  - fused K/V + RPE: cross-attention over per-source raw KNN targets, with
    the target LayerNorm folded into the K/V projection (agent->map⊕TL),
    and the same without RPE;
  - precomputed static K/V (TL->map, hoisted out of the rollout);
  - plain dense attention.
With `TransformerCfg.use_pallas=True` (and the `OpsCfg.use_pallas_attention`
kill switch on, folded in by `TrafficBots`) two branches run the KNARPE
attention kernels of `ops/knarpe.py`, behind the JAX package's gates
(`trafficbotsv15_tpu/models/transformer.py:346-396`): project-then-gather
with a raw rpe runs B4 (`knarpe_attention`), fused K/V + RPE runs B2
(`knarpe_cross_attention`). The heads' layout never changes the math, so
`seg_attn` selects nothing in the port: K/V stay full width and heads are
split where a reduction needs them.

`TransformerCfg.apply_q_rpe` adds a query RPE: one `rpe_proj` Dense of width
3 d_model gives (rpe_q, rpe_k, rpe_v), and the logits are
(q + rpe_q)·(k + rpe_k). As in the JAX package, such an attention never runs
the dense-KNN form, a kernel or a hoisted static K/V: it projects its
targets and its RPE and attends on the plain path (`knn_attention` with
rpe_q), whatever `use_pallas` says.

Dropout (`TransformerCfg.dropout_p`) sits where the JAX package puts it: on
each sub-layer's output (`drop_src`, `drop1`, `drop_ffn`, `drop2`), and on
the attention's output-projection input, or with `attn_dropout_weights` on
the softmax weights in every layout (the reference's placement). It draws
masks only inside a training `ops/dropout.py::dropout_scope`, in call order,
so the per-step recompute replays them. Dropout on the weights turns the
kernels off, as the JAX package's gates do.

The scene-centric model (`pairwise_relative=False`) builds every block with
`d_rpe = -1`: no RPE projection, the same branches without it. Its call
sites reach no kernel (B4 and B2 take an RPE). A decoder self-attention
without KNN indices, dense cross targets [b, t, d] and targets of a
self-attention raise: no model call site in either package reaches them.

The FFN's activation is `relu`, `gelu` (flax's `nn.gelu`, the tanh
approximation) or `elu`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from trafficbotsv15_tpu_torch.config import TransformerCfg
from trafficbotsv15_tpu_torch.models.mlp import Dense, LayerNorm
from trafficbotsv15_tpu_torch.ops import dropout as drop
from trafficbotsv15_tpu_torch.ops import knarpe
from trafficbotsv15_tpu_torch.ops.attention import _masked_softmax, dense_attention, knn_attention, knn_attention_fullwidth
from trafficbotsv15_tpu_torch.ops.rpe import gather_tgt


def standardize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without scale/bias, statistics in float32 (eps 1e-5, torch's default)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(var + eps)


ACTIVATIONS = {"relu": torch.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "elu": F.elu}


def check_transformer_cfg(tf_cfg: TransformerCfg) -> None:
    if tf_cfg.activation not in ACTIVATIONS:
        raise ValueError(f"activation {tf_cfg.activation!r}: one of {sorted(ACTIVATIONS)}")


class AttentionRPE(nn.Module):
    """Multi-head attention with relative-pose biases on K and V."""

    def __init__(self, d_model: int, n_head: int, d_rpe: int = -1, bias: bool = True,
                 dense_knn_max: int = 128, use_pallas: bool = False, dropout_p: float = 0.0,
                 attn_dropout_weights: bool = False, apply_q_rpe: bool = False, dtype=torch.float32):
        super().__init__()
        self.apply_q_rpe = apply_q_rpe and d_rpe > 0
        self.dropout_p, self.attn_dropout_weights = dropout_p, attn_dropout_weights
        self.d_model, self.n_head, self.d_rpe = d_model, n_head, d_rpe
        self.dense_knn_max = dense_knn_max
        # the KNARPE attention kernels (B4, B2), off with dropout on the weights as in the JAX package
        self.use_pallas = use_pallas and not attn_dropout_weights
        self.dtype = dtype
        self.q_proj = Dense(d_model, d_model, bias=bias, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, bias=bias, dtype=dtype)
        # raw [in, out] matrices (the flax layout), so K/V and RPE can be folded and fused
        self.kv_w = nn.Parameter(torch.empty(d_model, 2 * d_model))
        self.kv_b = nn.Parameter(torch.zeros(2 * d_model)) if bias else None
        if self.apply_q_rpe:
            self.rpe_proj = Dense(d_rpe, 3 * d_model, bias=bias, dtype=dtype)  # (rpe_q, rpe_k, rpe_v)
        elif d_rpe > 0:
            self.rpe_proj_w = nn.Parameter(torch.empty(d_rpe, 2 * d_model))
            self.rpe_proj_b = nn.Parameter(torch.zeros(2 * d_model))

    # -- projections -------------------------------------------------------
    def _kv_wb(self, ln=None):
        """W_kv and b_kv with an optional LayerNorm (gamma, beta) folded in,
        in float32: LN(x) @ W + b == x_hat @ (gamma * W) + (beta @ W + b)."""
        w, b = self.kv_w, self.kv_b
        if ln is not None:
            gamma, beta = ln
            b = beta @ w if b is None else b + beta @ w
            w = gamma[:, None] * w
        return w, b

    def _project_kv(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        """x @ W_kv + b -> [..., 2*d_model]."""
        w, b = self._kv_wb(ln)
        y = x.to(self.dtype) @ w.to(self.dtype)
        return y if b is None else y + b.to(self.dtype)

    def _rpe_kv(self, rpe: torch.Tensor):
        """rpe -> (rpe_k, rpe_v), each full width [..., d_model]."""
        dt = self.dtype
        proj = rpe.to(dt) @ self.rpe_proj_w.to(dt) + self.rpe_proj_b.to(dt)
        return proj.chunk(2, -1)

    def _project_kv_plus_rpe(self, tgt: torch.Tensor, rpe: torch.Tensor, ln=None):
        """(k + rpe_k, v + rpe_v) as one matmul over [tgt ⊕ rpe] @ [W_kv; W_rpe]."""
        dt = self.dtype
        wk, bk = self._kv_wb(ln)
        cat = torch.cat([tgt.to(dt), rpe.to(dt)], -1)
        w = torch.cat([wk, self.rpe_proj_w], 0).to(dt)
        b = self.rpe_proj_b if bk is None else bk + self.rpe_proj_b
        return (cat @ w + b.to(dt)).chunk(2, -1)

    def _q_rpe_attention(self, q, kv, rpe, tgt_padding_mask, attn_drop=None):
        """The apply_q_rpe attention over per-source K/V [b, s, K, 2D] and rpe [b, s, K, d_rpe] on the plain path:
        rpe_proj gives (rpe_q, rpe_k, rpe_v), and the logits are (q + rpe_q)·(k + rpe_k)."""
        n_b, n_src, n_knn = kv.shape[:3]
        split = lambda t: t.reshape(n_b, n_src, n_knn, self.n_head, self.d_model // self.n_head)  # noqa: E731
        k, v = (split(t) for t in kv.chunk(2, -1))
        rpe_q, rpe_k, rpe_v = (split(t) for t in self.rpe_proj(rpe).chunk(3, -1))
        qh = q.reshape(n_b, n_src, self.n_head, self.d_model // self.n_head)
        return knn_attention(qh, k, v, tgt_padding_mask, rpe_k, rpe_v, rpe_q=rpe_q, attn_drop=attn_drop)

    def static_kv(self, tgt: torch.Tensor, rpe: Optional[torch.Tensor], ln=None):
        """Scenario-static (k [+ rpe_k], v [+ rpe_v]) of per-source targets [b, s, K, d]."""
        if self.apply_q_rpe:
            raise ValueError("an apply_q_rpe attention hoists no static K/V: its query RPE is projected every step")
        if rpe is not None:
            return tuple(self._project_kv_plus_rpe(tgt, rpe, ln))
        return tuple(self._project_kv(tgt, ln).chunk(2, -1))

    def static_rpe_kv(self, rpe: torch.Tensor):
        """Scenario-static (rpe_k, rpe_v) for a KNN self-attention with static relative poses."""
        if self.apply_q_rpe:
            raise ValueError("an apply_q_rpe attention hoists no static K/V: its query RPE is projected every step")
        return tuple(self._rpe_kv(rpe))

    # -- attention ---------------------------------------------------------
    def _dense_knn_attention(self, q, kv, tgt_idx, tgt_padding_mask, rpe_k, rpe_v, attn_drop=None):
        """KNN self-attention as dense attention masked to the KNN slots.

        q [b, s, D], kv [b, t, 2D] (t == s), tgt_idx [b, s, K] (distinct per source),
        rpe_k / rpe_v full width [b, s, K, D] or None. The q.rpe_k bias is added
        at each slot's target column; exact because the K targets are distinct.
        """
        n_b, n_src, d_model = q.shape
        n_head = self.n_head
        d_head = d_model // n_head
        n_tgt, n_knn = kv.shape[1], tgt_idx.shape[-1]
        scale = 1.0 / math.sqrt(d_head)
        k, v = kv.chunk(2, -1)
        qh = q.reshape(n_b, n_src, n_head, d_head)
        k = k.reshape(n_b, n_tgt, n_head, d_head)
        v = v.reshape(n_b, n_tgt, n_head, d_head)

        valid_slot = torch.ones(tgt_idx.shape, dtype=q.dtype, device=q.device)
        if tgt_padding_mask is not None:
            valid_slot = (~tgt_padding_mask).to(q.dtype)
        hits = torch.zeros((n_b, n_src, n_tgt), dtype=q.dtype, device=q.device)
        dense_invalid = hits.scatter_add_(2, tgt_idx, valid_slot) <= 0.0

        logits = torch.einsum("bshd,bthd->bsht", qh, k) * scale
        idx_h = tgt_idx[:, :, None, :].expand(n_b, n_src, n_head, n_knn)
        if rpe_k is not None:
            q_rpe = (q[:, :, None, :] * rpe_k).reshape(n_b, n_src, n_knn, n_head, d_head).sum(-1) * scale
            logits = logits.scatter_add(3, idx_h, q_rpe.transpose(2, 3).to(logits.dtype))
        attn, no_valid = _masked_softmax(logits, dense_invalid[:, :, None, :])
        if attn_drop is not None:
            attn = attn_drop(attn)
        out = torch.einsum("bsht,bthd->bshd", attn, v)
        if rpe_v is not None:
            attn_knn = torch.gather(attn, 3, idx_h).to(q.dtype)  # [b, s, h, K]
            out = out + torch.einsum("bshk,bskhd->bshd", attn_knn,
                                     rpe_v.reshape(n_b, n_src, n_knn, n_head, d_head))
        out = torch.where(no_valid[..., None], 0.0, out)
        return out.reshape(n_b, n_src, d_model)

    def forward(self, src, tgt=None, tgt_padding_mask=None, rpe=None, kv_static=None,
                rpe_kv_static=None, tgt_idx=None, tgt_ln=None):
        """src [b, s, D]; tgt None (self) or [b, s, K, d] (per-source KNN targets);
        tgt_padding_mask True = invalid; tgt_idx [b, s, K] for KNN self-attention."""
        n_b, n_src, _ = src.shape
        n_head, d_head = self.n_head, self.d_model // self.n_head
        q = self.q_proj(src)
        wdrop = None
        if self.attn_dropout_weights and self.dropout_p > 0:
            wdrop = lambda a: drop.dropout(a, self.dropout_p)  # noqa: E731

        if kv_static is not None:
            out = knn_attention_fullwidth(q, kv_static[0], kv_static[1], tgt_padding_mask, n_head, wdrop)
        elif tgt_idx is not None and n_src <= self.dense_knn_max and not self.apply_q_rpe:
            rpe_k, rpe_v = rpe_kv_static if rpe_kv_static is not None else (
                self._rpe_kv(rpe) if rpe is not None else (None, None))
            out = self._dense_knn_attention(q, self._project_kv(src), tgt_idx, tgt_padding_mask, rpe_k, rpe_v,
                                            wdrop)
        elif tgt_idx is not None:
            # project the n_src tokens once, then gather (row-wise ops commute with the gather)
            kv = gather_tgt(self._project_kv(src), tgt_idx)
            n_knn = tgt_idx.shape[-1]
            if rpe is not None and self.apply_q_rpe:
                out = self._q_rpe_attention(q, kv, rpe, tgt_padding_mask, wdrop)
            elif rpe is not None and self.use_pallas:
                # kernel B4 fuses the rpe projection into the attention (JAX transformer.py:346-366)
                dt = self.dtype
                out = knarpe.knarpe_attention(q, *kv.chunk(2, -1), rpe.to(dt), self._invalid(tgt_padding_mask, kv),
                                              self.rpe_proj_w.to(dt), self.rpe_proj_b.to(dt), n_head)
            else:
                k, v = (t.reshape(n_b, n_src, n_knn, n_head, d_head) for t in kv.chunk(2, -1))
                rpe_k = rpe_v = None
                if rpe_kv_static is not None or rpe is not None:
                    rk, rv = rpe_kv_static if rpe_kv_static is not None else self._rpe_kv(rpe)
                    rpe_k = rk.reshape(n_b, n_src, n_knn, n_head, d_head)
                    rpe_v = rv.reshape(n_b, n_src, n_knn, n_head, d_head)
                out = knn_attention(q.reshape(n_b, n_src, n_head, d_head), k, v, tgt_padding_mask, rpe_k, rpe_v,
                                    attn_drop=wdrop)
        elif tgt is not None and tgt.ndim == 4:
            if rpe is None:
                # no kernel takes a KNN cross-attention without RPE, in either package
                kf, vf = self._project_kv(tgt, ln=tgt_ln).chunk(2, -1)
                out = knn_attention_fullwidth(q, kf, vf, tgt_padding_mask, n_head, wdrop)
            elif self.apply_q_rpe:
                out = self._q_rpe_attention(q, self._project_kv(tgt, ln=tgt_ln), rpe, tgt_padding_mask, wdrop)
            elif self.use_pallas:
                # kernel B2 fuses both projections into the attention (JAX transformer.py:367-396);
                # the target LayerNorm folds into W_kv and b in float32 before the cast
                dt = self.dtype
                wk, bk = self._kv_wb(tgt_ln)
                b_all = self.rpe_proj_b if bk is None else bk + self.rpe_proj_b
                out = knarpe.knarpe_cross_attention(q, tgt.to(dt), rpe.to(dt), self._invalid(tgt_padding_mask, tgt),
                                                    wk.to(dt), self.rpe_proj_w.to(dt), b_all.to(dt), n_head)
            else:
                kf, vf = self._project_kv_plus_rpe(tgt, rpe, ln=tgt_ln)
                out = knn_attention_fullwidth(q, kf, vf, tgt_padding_mask, n_head, wdrop)
        else:
            n_tgt = n_src if tgt is None else tgt.shape[1]
            kv = self._project_kv(src if tgt is None else tgt, ln=tgt_ln if tgt is not None else None)
            k, v = (t.reshape(n_b, n_tgt, n_head, d_head) for t in kv.chunk(2, -1))
            invalid = tgt_padding_mask
            if invalid is not None and invalid.ndim == 2:
                invalid = invalid[:, None, :].expand(n_b, n_src, n_tgt)
            out = dense_attention(q.reshape(n_b, n_src, n_head, d_head), k, v, invalid, wdrop)

        out = self.out_proj(out if self.attn_dropout_weights else drop.dropout(out, self.dropout_p))
        if tgt_padding_mask is not None:
            no_valid = tgt_padding_mask.all(-1)
            if no_valid.ndim == 1:  # dense 2D padding mask: per batch
                no_valid = no_valid[:, None].expand(n_b, n_src)
            out = torch.where(no_valid[..., None], 0.0, out)
        return out

    @staticmethod
    def _invalid(tgt_padding_mask, per_src_kv: torch.Tensor) -> torch.Tensor:
        """The kernels' [b, s, K] invalid mask (all valid when none is given)."""
        if tgt_padding_mask is None:
            return torch.zeros(per_src_kv.shape[:3], dtype=torch.bool, device=per_src_kv.device)
        return tgt_padding_mask.contiguous()


class TransformerLayer(nn.Module):
    """Pre-LN residual layer: (decoder KNN self-attention) + attention + FFN."""

    def __init__(self, tf_cfg: TransformerCfg, mode: str, d_rpe: int, dtype=torch.float32):
        super().__init__()
        d = tf_cfg.d_model
        self.mode = mode
        self.dropout_p = tf_cfg.dropout_p
        self.act = ACTIVATIONS[tf_cfg.activation]
        attn_kw = dict(d_model=d, n_head=tf_cfg.n_head, d_rpe=d_rpe, bias=tf_cfg.bias,
                       dense_knn_max=tf_cfg.dense_knn_max, use_pallas=tf_cfg.use_pallas,
                       dropout_p=tf_cfg.dropout_p, attn_dropout_weights=tf_cfg.attn_dropout_weights,
                       apply_q_rpe=tf_cfg.apply_q_rpe, dtype=dtype)
        if mode == "dec_cross_attn":
            self.norm_src = LayerNorm(d, dtype=dtype)
            self.attn_src = AttentionRPE(**attn_kw)
        self.norm1 = LayerNorm(d, dtype=dtype)
        self.attn = AttentionRPE(**attn_kw)
        if mode != "enc_self_attn":
            # LayerNorm scale/bias of the KNN cross targets, folded into the K/V projection
            self.norm_tgt_scale = nn.Parameter(torch.ones(d))
            self.norm_tgt_bias = nn.Parameter(torch.zeros(d))
        self.norm2 = LayerNorm(d, dtype=dtype)
        self.ffn1 = Dense(d, tf_cfg.k_feedforward * d, bias=tf_cfg.bias, dtype=dtype)
        self.ffn2 = Dense(tf_cfg.k_feedforward * d, d, bias=tf_cfg.bias, dtype=dtype)

    def static_kv(self, tgt, rpe, decoder_rpe):
        """(cross-attention static K/V of standardized targets, decoder static rpe K/V)."""
        cross_kv = None
        if tgt is not None:
            cross_kv = self.attn.static_kv(standardize(tgt), rpe, ln=(self.norm_tgt_scale, self.norm_tgt_bias))
        dec_rpe_kv = None
        if self.mode == "dec_cross_attn" and decoder_rpe is not None:
            dec_rpe_kv = self.attn_src.static_rpe_kv(decoder_rpe)
        return cross_kv, dec_rpe_kv

    def forward(self, src, src_padding_mask=None, tgt=None, tgt_padding_mask=None, rpe=None,
                decoder_tgt_padding_mask=None, decoder_rpe=None, cross_kv_static=None,
                decoder_rpe_kv_static=None, tgt_idx=None, decoder_tgt_idx=None, tgt_standardized=False):
        if self.mode == "dec_cross_attn":
            if decoder_tgt_idx is None:
                raise ValueError("a decoder self-attention without KNN indices: no model call site reaches it")
            s = self.attn_src(self.norm_src(src), None, tgt_padding_mask=decoder_tgt_padding_mask,
                              rpe=decoder_rpe, rpe_kv_static=decoder_rpe_kv_static, tgt_idx=decoder_tgt_idx)
            src = src + drop.dropout(s, self.dropout_p)

        src2 = self.norm1(src)
        t, t_ln = tgt, None
        if cross_kv_static is not None:
            t = None
        elif t is None and tgt_idx is None:
            tgt_padding_mask = src_padding_mask if tgt_padding_mask is None else tgt_padding_mask
        elif t is not None:
            if self.mode == "enc_self_attn" or t.ndim != 4:
                raise ValueError("dense cross-attention targets, or targets of a self-attention: no model call "
                                 "site reaches them")
            if not tgt_standardized:
                t = standardize(t)
            t_ln = (self.norm_tgt_scale, self.norm_tgt_bias)
        src2 = self.attn(src2, t, tgt_padding_mask=tgt_padding_mask, rpe=rpe, kv_static=cross_kv_static,
                         tgt_idx=tgt_idx, tgt_ln=t_ln)
        src = src + drop.dropout(src2, self.dropout_p)
        ffn = drop.dropout(self.act(self.ffn1(self.norm2(src))), self.dropout_p)
        src = src + drop.dropout(self.ffn2(ffn), self.dropout_p)
        if src_padding_mask is not None:
            src = torch.where(src_padding_mask[..., None], 0.0, src)
        return src


class TransformerBlock(nn.Module):
    """Stack of TransformerLayers (`layer0`, `layer1`, ...)."""

    def __init__(self, tf_cfg: TransformerCfg, n_layer: int, mode: str, d_rpe: int, dtype=torch.float32):
        super().__init__()
        if mode not in ("enc_self_attn", "enc_cross_attn", "dec_cross_attn"):
            raise ValueError(mode)
        check_transformer_cfg(tf_cfg)
        self.mode = mode
        self.dtype = dtype
        self.n_layer = n_layer
        for i in range(n_layer):
            self.add_module(f"layer{i}", TransformerLayer(tf_cfg, mode, d_rpe, dtype=dtype))
        self.out_ln = LayerNorm(tf_cfg.d_model, dtype=dtype) if tf_cfg.out_layernorm else None

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.n_layer)]

    def compute_static_kv(self, tgt=None, rpe=None, decoder_rpe=None):
        """Per-layer [(cross_kv, dec_rpe_kv)] of scenario-static targets, reused every step."""
        return [layer.static_kv(tgt, rpe, decoder_rpe) for layer in self.layers()]

    def forward(self, src, src_padding_mask=None, tgt=None, tgt_idx=None, tgt_padding_mask=None, rpe=None,
                decoder_tgt_idx=None, decoder_tgt_padding_mask=None, decoder_rpe=None, static_kv=None):
        tgt_standardized = tgt is not None and tgt.ndim == 4 and self.mode != "enc_self_attn"
        if tgt_standardized:
            # per-layer LayerNorms of the shared KNN targets differ only by scale/bias,
            # which fold into each layer's K/V projection: standardize once
            tgt = standardize(tgt).to(self.dtype)
        for i, layer in enumerate(self.layers()):
            ckv, drkv = static_kv[i] if static_kv is not None else (None, None)
            src = layer(src, src_padding_mask=src_padding_mask, tgt=tgt, tgt_padding_mask=tgt_padding_mask,
                        rpe=rpe, decoder_tgt_padding_mask=decoder_tgt_padding_mask, decoder_rpe=decoder_rpe,
                        cross_kv_static=ckv, decoder_rpe_kv_static=drkv, tgt_idx=tgt_idx,
                        decoder_tgt_idx=decoder_tgt_idx, tgt_standardized=tgt_standardized)
        if self.out_ln is not None:
            src = self.out_ln(src)
        return src
