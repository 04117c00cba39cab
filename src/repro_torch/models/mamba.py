"""Mamba (selective SSM) mixer, the state-space half of Jamba (the port of
the JAX package's ``repro.models.mamba``).

The recurrence (diagonal A), per channel and state:

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + Δ_t ⊙ B_t · x_t
    y_t = C_t · h_t + D ⊙ x_t

A prefill runs it over chunks of ``chunk`` (256) steps: each chunk's
decays and inputs ``(B, c, din, N)`` are formed, then stepped through in
order from the carried state, and only the chunk's outputs leave it, so
memory is O(B·chunk·din·N) whatever the sequence length (the reference
scans each chunk associatively, padded to a whole chunk; a padded step
has decay 1 and input 0 and changes nothing).  Decode is the one-step
update on the carried ``(conv, ssm)`` cache: the causal depthwise conv's
last ``d_conv - 1`` inputs and the f32 state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import Params, _identity, _normal, _split

__all__ = ["init_mamba", "mamba", "init_mamba_cache"]


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.mamba_dt_rank or -(-cfg.d_model // 16)


def init_mamba(key, cfg: ArchConfig, dtype, device=None) -> Params:
    d = cfg.d_model
    din = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    r = _dt_rank(cfg)
    ks = _split(key, 6)
    # S4D-real A (negative reals), stored as log
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device).expand(din, n)
    return Params(
        in_proj=_normal(ks[0], (d, 2 * din), dtype, device),
        conv_w=_normal(ks[1], (cfg.mamba_d_conv, din), dtype, device,
                       scale=0.1),
        conv_b=torch.zeros((din,), dtype=dtype, device=device),
        x_proj=_normal(ks[2], (din, r + 2 * n), dtype, device),
        dt_proj_w=_normal(ks[3], (r, din), dtype, device, scale=r ** -0.5),
        dt_proj_b=torch.full((din,), -4.6, dtype=dtype, device=device),
        a_log=torch.log(a).contiguous(),
        d_skip=torch.ones((din,), dtype=torch.float32, device=device),
        out_proj=_normal(ks[4], (din, d), dtype, device))


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    din = cfg.mamba_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, din),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, din, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}


def _scan(dt, xf, bmat, cmat, a, h, chunk: int):
    """Run the recurrence over ``S`` steps from state ``h`` (B, din, N):
    dt, xf (B, S, din), bmat, cmat (B, S, N) f32; a (din, N).  Returns
    (y (B, S, din) without the skip term, the last state)."""
    S = dt.shape[1]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        da = torch.exp(dt[:, sl, :, None] * a)               # (B, c, din, N)
        db = (dt[:, sl] * xf[:, sl])[..., None] * bmat[:, sl, None, :]
        hs = []
        for t in range(da.shape[1]):
            h = da[:, t] * h + db[:, t]
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, 1),
                               cmat[:, sl]))
    return torch.cat(ys, 1), h


def mamba(
    p: Params, cfg: ArchConfig, x: torch.Tensor,
    cache: Optional[Dict] = None, *, chunk: int = 256,
    constrain=_identity,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, D) -> (y (B, S, D), new_cache).  A prefill with a cache
    takes the conv inputs from it and starts the scan from a zero state,
    as the reference does."""
    B, S, D = x.shape
    n, r, dconv = cfg.mamba_d_state, _dt_rank(cfg), cfg.mamba_d_conv

    xs, z = (x @ p.in_proj).chunk(2, dim=-1)           # (B, S, din) each
    xs = constrain(xs, "mamba_inner")

    # causal depthwise conv
    if cache is None:
        conv_in = F.pad(xs, (0, 0, dconv - 1, 0))
    else:
        conv_in = torch.cat([cache["conv"].to(xs.dtype), xs], 1)
    xc = conv_in[:, 0:S] * p.conv_w[0]
    for i in range(1, dconv):
        xc = xc + conv_in[:, i:i + S] * p.conv_w[i]
    xc = F.silu(xc + p.conv_b)

    proj = xc @ p.x_proj                                # (B, S, r+2n)
    dt = F.softplus(proj[..., :r] @ p.dt_proj_w + p.dt_proj_b).float()
    bmat = proj[..., r:r + n].float()
    cmat = proj[..., r + n:].float()
    a = -torch.exp(p.a_log)                             # (din, n)
    xf = xc.float()

    if cache is None or S > 1:
        h0 = xf.new_zeros((B, xf.shape[-1], n))
        y, h_last = _scan(dt, xf, bmat, cmat, a, h0, chunk)
    else:
        da = torch.exp(dt[:, 0, :, None] * a)
        db = (dt[:, 0] * xf[:, 0])[..., None] * bmat[:, 0, None, :]
        h_last = da * cache["ssm"] + db
        y = torch.einsum("bdn,bn->bd", h_last, cmat[:, 0])[:, None]

    y = y + xf * p.d_skip
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p.out_proj
    new_cache = None
    if cache is not None:
        new_cache = {"conv": conv_in[:, conv_in.shape[1] - (dconv - 1):],
                     "ssm": h_last}
    return out, new_cache
