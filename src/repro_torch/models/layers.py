"""Shared model building blocks (plain functions on tensors).

Every block takes ``(params, x, cfg, ...)``.  Attention has two kernel
paths: ``cfg.kernels == "cuda"`` sends it through the hand-written kernels
of ``repro_torch.kernels`` (FlashAttention for a prompt, flash-decode with a
valid length for a cached step; on CPU tensors those wrappers run their
plain versions), anything else takes the dense plain path below.
Projections, the MLP and the LM head are ``torch.einsum``, as the reference
leaves them to XLA.  Weights are cast to the activation dtype at every use,
as in the reference; a caller that holds its weights in the compute dtype
already (``launch.serve.load_params`` draws them in it) pays nothing for
it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .param import LeafSpec

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ------------------------------------------------------------------ norms
def rmsnorm_spec(d: int) -> Params:
    return {"scale": LeafSpec((d,), ("embed",), init="ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(dt)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions.float()[..., None] * freq          # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) with D even; cos/sin: (S, D/2).  Split-half layout."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
def attention_spec(cfg: ModelConfig, cross: bool = False) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    spec: Params = {
        "wq": LeafSpec((d, nh, hd), ("embed", "q_heads", "head_dim")),
        "wk": LeafSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": LeafSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": LeafSpec((nh, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = LeafSpec((nh, hd), ("q_heads", "head_dim"), init="zeros")
        spec["bk"] = LeafSpec((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = LeafSpec((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _sdpa_plain_dense(q, k, v, causal: bool, sm_scale: float,
                      kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,H,D) -> (B,S,H,D)."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * sm_scale
    S, T = s.shape[-2], s.shape[-1]
    neg = torch.full_like(s, float("-inf"))
    if causal:
        qi = torch.arange(S, device=s.device)[:, None] + (T - S)   # align ends
        ki = torch.arange(T, device=s.device)[None, :]
        s = torch.where(qi >= ki, s, neg)
    if kv_valid_len is not None:
        ki = torch.arange(T, device=s.device)
        s = torch.where((ki < kv_valid_len)[None, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype)


def _sdpa_kernel(q, k, v, causal: bool, sm_scale: float, q_per_kv: int,
                 kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Attention through the kernels of ``repro_torch.kernels.ops``.

    q: (B,S,H,D); k/v: (B,T,Hkv,D), *not* repeated: the kernels map query
    head h to kv head h // q_per_kv themselves and read k/v through a
    strided (B,Hkv,T,D) view, so a serving cache is neither repeated nor
    transposed.  S == 1 goes to flash-decode over the first ``kv_valid_len``
    keys, anything else to the FlashAttention kernel over all T keys.
    """
    from repro_torch.kernels import ops
    B, S, H, D = q.shape
    qf = q.permute(0, 2, 1, 3).reshape(B * H, S, D)
    kf = k.permute(0, 2, 1, 3)
    vf = v.permute(0, 2, 1, 3)
    if S == 1:
        out = ops.flash_decode(qf, kf, vf, sm_scale=sm_scale,
                               kv_valid_len=kv_valid_len, q_per_kv=q_per_kv)
    else:
        out = ops.attention(qf, kf, vf, sm_scale=sm_scale, causal=causal,
                            q_per_kv=q_per_kv)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_index: Optional[int] = None,
              use_rope: bool = True):
    """GQA self-attention.  Returns (out, new_kv_cache | None).

    * train/prefill without a cache: ``kv_cache is None``: full causal
      self-attention.
    * cached: ``kv_cache=(k, v)`` of shape (B, T, nkv, hd); the S new tokens'
      k/v are written at ``cache_index`` **in place** and the same tensors
      are returned.  With S == 1 this is a decode step over the
      ``cache_index + 1`` valid keys.  With S > 1 it is a prompt pass: the
      tokens attend causally to each other (which is what feeding them one
      by one computes), and the cache must be empty below them
      (``cache_index == 0``).

    The reference's cross-attention modes (``kv_input``,
    ``precomputed_kv``) arrive with the encoder-decoder family.
    """
    B, S, d = x.shape
    hd = cfg.head_dim_
    q, k, v = _project_qkv(p, x, cfg)
    cached = kv_cache is not None and cache_index is not None
    if use_rope:
        if cached:
            pos = cache_index + torch.arange(S, device=x.device)
        else:
            pos = positions if positions is not None \
                else torch.arange(S, device=x.device)
        cos, sin = rope_frequencies(hd, cfg.rope_theta, pos)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    new_cache = None
    valid = None
    is_causal = causal and kv_cache is None
    if kv_cache is not None:
        ck, cv = kv_cache
        if cached:
            if S > 1 and cache_index != 0:
                raise NotImplementedError(
                    "a multi-token pass into a cache that already holds keys "
                    "(chunked prefill) is not supported: prefill from index 0")
            ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
            valid = cache_index + S
        # attend over the cache, in its dtype, as the reference does
        k, v = ck, cv
        if cached and S > 1:
            # prompt pass: the S tokens see each other causally, which is
            # what feeding them one by one computes
            k, v = ck[:, :valid], cv[:, :valid]
            valid = None
            is_causal = causal
        new_cache = (ck, cv)
    sm_scale = hd ** -0.5
    if cfg.kernels == "cuda":
        if q.dtype != k.dtype:
            k, v = k.to(q.dtype), v.to(q.dtype)
        out = _sdpa_kernel(q, k, v, is_causal, sm_scale, cfg.q_per_kv,
                           kv_valid_len=valid)
    else:
        kr = _repeat_kv(k, cfg.q_per_kv)
        vr = _repeat_kv(v, cfg.q_per_kv)
        out = _sdpa_plain_dense(q, kr, vr, is_causal, sm_scale, kv_valid_len=valid)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, new_cache


# -------------------------------------------------------------------- MLP
def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": LeafSpec((d, f), ("embed", "ffn")),
        "w_up": LeafSpec((d, f), ("embed", "ffn")),
        "w_down": LeafSpec((f, d), ("ffn", "embed")),
    }


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.mlp_activation == "gelu" else F.silu(g)
    return torch.einsum("bsf,fd->bsd", act * u, p["w_down"].to(x.dtype))


# -------------------------------------------------------------- embeddings
def embedding_spec(cfg: ModelConfig) -> Params:
    return {"table": LeafSpec((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), scale=1.0)}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens, p["table"]).to(cdtype(cfg))


def lm_head_spec(cfg: ModelConfig) -> Params:
    if cfg.tie_embeddings:
        return {}
    return {"w": LeafSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))}


def lm_head(p: Params, x: torch.Tensor, cfg: ModelConfig,
            embed_params: Optional[Params] = None) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = embed_params["table"].to(x.dtype).T
    else:
        w = p["w"].to(x.dtype)
    return torch.einsum("bsd,dv->bsv", x, w)
