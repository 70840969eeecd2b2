"""Mamba2 (SSD) block, the state-space component of zamba2-1.2b.

Counterpart of ``repro/models/mamba2.py``.  The chunked SSD scan

    h_t = exp(A dt_t) h_{t-1} + dt_t * (x_t (x) B_t)
    y_t = C_t . h_t + D * x_t

is plain PyTorch, float32 inside, as the reference's is plain array code: no
kernel of the port runs it.  One scalar decay A per head (the reference's
``n_groups = 1`` simplification, kept).  Decode carries (ssd_state,
conv_state) per layer, O(1) per token.

Under a plan-sharded step with a local axis (``parallel/spmd.py``: the
step left ``out_proj``'s rows split) the rank computes its heads, as GSPMD
places the reference's activations: ``in_proj`` concatenates z | xin | B |
C | dt, so the plan's contiguous split of its columns (and of the conv's
xin | B | C channels) does not line up with the heads; those leaves are
used whole (gathered, their gradient summed over the axis and
reduce-scattered back), and the rank takes its heads' columns of z, xin
and dt and all of B and C (every head reads them), convolves its xin
channels and B and C, scans its heads, sums the gated norm's squares over
the axis, and ``out_proj`` is row-parallel, summed over the axis (a split
of ``out_proj``'s rows that cuts a head runs the block whole).  Under a
step that splits the sequence the rank computes its token block: the
causal conv reads the previous rank's last K - 1 inputs, and the scan's
state entering the block is the fold of the earlier blocks' own final
states (``spmd.carry_states``), whose read is added to the block's
zero-start scan.  Under ``tp2d`` the rank also holds a block of the
residual's channels: ``in_proj``'s partial products are summed over the
ranks that hold the others, the conv, the scan and the gated norm run on
whole heads, and ``out_proj`` produces the rank's block.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import spmd
from . import layers as L
from .param import LeafSpec

Params = Dict[str, Any]
SSD_HEAD_DIM = 64


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.ssm_heads or d_inner // SSD_HEAD_DIM
    dh = d_inner // n_heads
    return d_inner, n_heads, dh, cfg.ssm_state


def mamba2_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    d_inner, H, dh, ds = dims(cfg)
    conv_dim = d_inner + 2 * ds
    return {
        "in_proj": LeafSpec((d, 2 * d_inner + 2 * ds + H), ("embed", "ffn")),
        "conv_w": LeafSpec((cfg.conv_kernel, conv_dim), ("conv", "ffn"),
                           init="scaled", scale=0.1),
        "conv_b": LeafSpec((conv_dim,), ("ffn",), init="zeros"),
        "A_log": LeafSpec((H,), ("ssm_heads",), init="scaled", scale=0.5),
        "D": LeafSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": LeafSpec((H,), ("ssm_heads",), init="zeros"),
        "norm_scale": LeafSpec((d_inner,), ("ffn",), init="ones"),
        "out_proj": LeafSpec((d_inner, d), ("ffn", "embed")),
    }


def _block_of(state: Optional[torch.Tensor], logical: str, n: int):
    """(mesh axes, offset, length) of this rank's block of the ``logical``
    dim (of size ``n``) of a recurrent cache leaf: all of it, or its block
    under a serving plan that splits the leaf there."""
    split = None if state is None else spmd.cache_split(state)
    if split is None or not split.split_dims():
        return (), 0, n
    if set(split.split_dims()) != {logical}:
        raise NotImplementedError(f"a Mamba2 state split over {split.split_dims()} is "
                                  f"not decoded: only a split over {logical} is")
    off, length = split.block(logical)
    return split.mesh_axes_of(logical), off, length


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, T, C); w: (K, C).  Returns
    ``(silu(y + b), new_state)``, the state being the last K-1 inputs; it
    starts from zeros, or from ``state`` (decode)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, T+K-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):]
    return F.silu(y + b[None, None, :]), new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bmat: torch.Tensor,
                Cmat: torch.Tensor, h0: Optional[torch.Tensor] = None,
                chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,dh); dt: (B,T,H); A: (H,) (negative); B/C: (B,T,ds).
    Returns (y float32 (B,T,H,dh), h_final (B,H,dh,ds)).

    The reference scans the chunks one after another; here every chunk's
    own part (the masked intra-chunk product and the chunk's contribution
    to the state) is computed for all chunks at once, and only the state's
    recurrence over chunks is a loop, followed by each chunk's read of the
    state it started from.  The arithmetic per element is the reference's."""
    Bsz, T, H, dh = x.shape
    ds = Bmat.shape[-1]
    c = min(chunk, T)
    if c < 1 or T % c:
        raise ValueError(f"the SSD scan needs T divisible by its chunk: T={T}, chunk={c}")
    n = T // c
    da = (dt * A[None, None, :]).float().reshape(Bsz, n, c, H)       # <= 0
    xc = (x * dt[..., None]).float().reshape(Bsz, n, c, H, dh)        # dt-weighted input
    bc = Bmat.float().reshape(Bsz, n, c, ds)
    cc = Cmat.float().reshape(Bsz, n, c, ds)
    cum = torch.cumsum(da, dim=2)                                      # (B,n,c,H) inclusive
    # intra-chunk: scores[t,s] = e^{cum[t]-cum[s]} (C_t . B_s), s <= t.  The
    # valid (t >= s) differences are <= 0; clamping before exp keeps the
    # masked upper triangle from overflowing to inf (inf * 0 = nan)
    diff = torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :], max=0.0)
    mask = torch.tril(torch.ones(c, c, device=x.device))
    cb = torch.einsum("bntd,bnsd->bnts", cc, bc)
    scores = torch.exp(diff) * cb[..., None] * mask[None, None, :, :, None]
    y = torch.einsum("bntsh,bnshd->bnthd", scores, xc)
    # each chunk's own contribution to the state it hands on
    k_carry = torch.exp(cum[:, :, -1:, :] - cum)                       # (B,n,c,H)
    upd = torch.einsum("bnthd,bnth,bnts->bnhds", xc, k_carry, bc)
    decay_all = torch.exp(cum[:, :, -1])                               # (B,n,H)
    h = torch.zeros((Bsz, H, dh, ds), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    starts = []
    for i in range(n):
        starts.append(h)
        h = h * decay_all[:, i, :, None, None] + upd[:, i]
    # inter-chunk: each chunk reads the state it started from, decayed e^{cum[t]}
    h_in = torch.stack(starts, dim=1)                                  # (B,n,H,dh,ds)
    y = y + torch.einsum("bntd,bnhed,bnth->bnthe", cc, h_in, torch.exp(cum))
    return y.reshape(Bsz, T, H, dh), h


def _carry_ssd(y: torch.Tensor, own: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Cmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of a scan the step splits along the sequence: ``y``
    and ``own`` are the block scanned from zero; the state entering it
    (the earlier blocks' states folded, ``spmd.carry_states``) adds its
    decayed read ``C_t . h e^{cum_t}`` to every step.  Returns (y, the
    state after the whole sequence)."""
    da = (dt * A[None, None, :]).float()                              # as ssd_chunked's
    entering, final = spmd.carry_states(own, da.sum(dim=1)[..., None, None])
    y = y + torch.einsum("btd,bhed,bth->bthe", Cmat.float(), entering,
                         torch.exp(torch.cumsum(da, dim=1)))
    return y, final


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 ssd_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None, carry: bool = False):
    """Returns ``(out, (new_ssd_state, new_conv_state))``.  Without
    ``ssd_state`` the chunked scan runs from zero over all T tokens (its
    pair is what a prefill stores); with it, T == 1 and the single-token
    recurrence runs in float32.  ``carry``: a prompt pass whose pair a cache
    keeps (the local path then hands back the conv state of every channel;
    elsewhere it is None there)."""
    axis = spmd.local_of(p["out_proj"]) if ssd_state is None else None
    if axis is not None and p["out_proj"].shape[0] % dims(cfg)[2] == 0:
        return _mamba2_local(p, x, cfg, axis, carry)
    if axis is not None:                  # a split that cuts a head: run whole
        p = spmd.unsplit(p, _SPLIT)
    B, T, d = x.shape
    d_inner, H, dh, ds = dims(cfg)
    e_ax = spmd.embed_of(p["in_proj"])
    proj = x @ p["in_proj"].to(x.dtype)
    if e_ax is not None:                 # tp2d: x is the rank's block of embed
        proj = L._sum_partials(proj, e_ax)
    z, xin, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, ds, ds, H], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    split_seq = ssd_state is None and spmd.seq_axis() is not None
    if split_seq:
        # the previous rank's last K - 1 inputs start this block's conv
        halo, new_conv = spmd.seq_edges(conv_in, cfg.conv_kernel - 1)
        conv_out, _ = _causal_conv(conv_in, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                   halo)
    else:
        # a serving plan may split the conv state over its channels (``ffn``)
        # and the SSD state over heads: each rank convolves its channels and
        # runs its heads, and the results are gathered
        ch, c0, cn = _block_of(conv_state, "ffn", conv_in.shape[-1])
        conv_out, new_conv = _causal_conv(conv_in[..., c0:c0 + cn],
                                          p["conv_w"][:, c0:c0 + cn].to(x.dtype),
                                          p["conv_b"][c0:c0 + cn].to(x.dtype), conv_state)
        if ch:
            conv_out = spmd.gather_over(conv_out, ch, 2)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float()[None, None, :])
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, T, H, dh)
    if ssd_state is None:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm)
        if split_seq:
            y, new_state = _carry_ssd(y, new_state, dt, A, Cm)
    else:
        # single-token recurrence (decode), over this rank's heads
        heads, h0, hn = _block_of(ssd_state, "ssm_heads", H)
        dt0 = dt[:, 0, h0:h0 + hn]
        da = torch.exp(dt0 * A[None, h0:h0 + hn])                      # (B,hn)
        xr = (xh[:, 0, h0:h0 + hn] * dt0[..., None]).float()
        upd = torch.einsum("bhd,bs->bhds", xr, Bm[:, 0].float())
        new_state = ssd_state * da[:, :, None, None] + upd
        y = torch.einsum("bs,bhds->bhd", Cm[:, 0].float(), new_state)[:, None]
        if heads:
            y = spmd.gather_over(y, heads, 2)
    y = y.to(x.dtype).reshape(B, T, d_inner) \
        + xin * torch.repeat_interleave(p["D"].to(x.dtype), dh)[None, None, :]
    # gated RMS norm, in float32
    y32 = (y * F.silu(z)).float()
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"].float()).to(x.dtype)
    if e_ax is not None:                 # the rank's block of embed out
        y = spmd.enter(y, e_ax)
    return y @ p["out_proj"].to(x.dtype), (new_state, new_conv)


# the dims the plan may leave split for local compute
_SPLIT = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "A_log": 0, "D": 0, "dt_bias": 0,
          "norm_scale": 0, "out_proj": 0}


def _used_whole(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """A leaf every rank along ``axis`` uses whole, each for its own part of
    the gradient: gathered where the step left it split there (its gradient
    reduce-scattered back), else entered (its gradient summed)."""
    if spmd.local_of(t) == axis:
        return spmd.gather_used(t, axis, dim)
    return spmd.enter(t, axis)


def _heads_block(t: torch.Tensor, axis: str, start: int, n: int) -> torch.Tensor:
    """The rank's block ``[start, start + n)`` of a leaf indexed by heads or
    their channels: the leaf itself where the step left it split over
    ``axis`` at that block, else its slice after ``spmd.enter``."""
    if spmd.local_of(t) == axis and t.shape[0] == n:
        return t
    return spmd.enter(t, axis)[start:start + n]


def mamba2_head_columns(cfg: ModelConfig, h0: int, hn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The columns of ``in_proj`` (z | xin | B | C | dt) and the channels of
    the conv (xin | B | C) that heads ``[h0, h0 + hn)`` read: their z, xin
    and dt columns and every B and C column."""
    d_inner, H, dh, ds = dims(cfg)
    heads = torch.arange(h0 * dh, (h0 + hn) * dh)
    bc = torch.arange(2 * ds)
    cols = torch.cat([heads, d_inner + heads, 2 * d_inner + bc,
                      2 * d_inner + 2 * ds + torch.arange(h0, h0 + hn)])
    return cols, torch.cat([heads, d_inner + bc])


def _mamba2_local(p: Params, x: torch.Tensor, cfg: ModelConfig, axis: str, carry: bool):
    """:func:`mamba2_apply`'s prompt pass over this rank's heads (the module
    docstring); its SSD state is this rank's heads'."""
    B, T, d = x.shape
    d_inner, H, dh, ds = dims(cfg)
    x = spmd.enter(x, axis)
    hn = p["out_proj"].shape[0] // dh
    h0 = spmd.axis_index(axis) * hn
    cols, conv_ch = (c.to(x.device) for c in mamba2_head_columns(cfg, h0, hn))
    w_in = _used_whole(p["in_proj"], axis, 1)
    proj = x @ w_in.index_select(1, cols).to(x.dtype)
    z, xin, Bm, Cm, dt = torch.split(proj, [hn * dh, hn * dh, ds, ds, hn], dim=-1)
    conv_w = _used_whole(p["conv_w"], axis, 1).index_select(1, conv_ch)
    conv_b = _used_whole(p["conv_b"], axis, 0).index_select(0, conv_ch)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, tail = _causal_conv(conv_in, conv_w.to(x.dtype), conv_b.to(x.dtype))
    xin, Bm, Cm = torch.split(conv_out, [hn * dh, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + _heads_block(p["dt_bias"], axis, h0, hn).float()[None, None, :])
    A = -torch.exp(_heads_block(p["A_log"], axis, h0, hn).float())
    y, new_state = ssd_chunked(xin.reshape(B, T, hn, dh), dt, A, Bm, Cm)
    D = _heads_block(p["D"], axis, h0, hn)
    y = y.to(x.dtype).reshape(B, T, hn * dh) \
        + xin * torch.repeat_interleave(D.to(x.dtype), dh)[None, None, :]
    # gated RMS norm over all d_inner channels: the squares summed over the axis
    y32 = (y * F.silu(z)).float()
    sq = spmd.psum(spmd.enter(torch.sum(torch.square(y32), dim=-1, keepdim=True), axis), axis)
    scale = _heads_block(p["norm_scale"], axis, h0 * dh, hn * dh)
    y = (y32 * torch.rsqrt(sq / d_inner + cfg.norm_eps) * scale.float()).to(x.dtype)
    out = y @ _heads_block(p["out_proj"], axis, h0 * dh, hn * dh).to(x.dtype)
    new_conv = None
    if carry:
        # the conv state of every channel: the ranks' xin tails, then B and C
        xt = spmd.gather_over(tail[..., :hn * dh].contiguous(), axis, 2)
        new_conv = torch.cat([xt, tail[..., hn * dh:]], dim=-1)
    return spmd.psum(out, axis), (new_state, new_conv)
