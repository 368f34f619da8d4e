"""Mamba2 (SSD) block, chunked-scan form, for the hybrid family's backbone.

The counterpart of ``repro.models.mamba2``. Per head h with head dim P and
state dim N:

    S_t = exp(dt_t * A_h) S_{t-1} + dt_t * x_t B_t^T     (P x N state)
    y_t = S_t C_t + D_h x_t

which is the gated-linear recurrence of ``xlstm.chunked_gated_linear`` with
q = C, k = B, v = dt * x, log_f = dt * A, i = 1. A causal depthwise conv
(width ``conv_width``) runs over the x/B/C stream, then SiLU, and the
output is gated. Decode keeps (conv window, SSM state) as its cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamInit, dense_param, torch_dtype
from repro_torch.models.xlstm import chunked_gated_linear, gated_linear_step


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_channels) rolling input window
    ssm: torch.Tensor    # (B, H, N, P) state (dk=N, dv=P in the shared kernel)


def _conv_channels(cfg):
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba2(init: ParamInit, cfg, ctx):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    dt_ = torch_dtype(cfg.dtype)
    p, s = {}, {}
    # in_proj -> [z (gate, di), x (di), B (N), C (N), dt (H)]
    p["win"], s["win"] = dense_param(init, d, 2 * di + 2 * N + H, ctx, dt_)
    p["wout"], s["wout"] = dense_param(init, di, d, ctx, dt_, tp_dim="in")
    p["conv_w"] = init.normal((cfg.conv_width, _conv_channels(cfg)), 0.2, dt_)
    s["conv_w"] = (None, None)
    p["a_log"] = init.value(
        np.log(np.linspace(1.0, 16.0, H).astype(np.float32)), torch.float32)
    s["a_log"] = (None,)
    p["d_skip"] = init.full((H,), 1.0, torch.float32)
    s["d_skip"] = (None,)
    p["dt_bias"] = init.full((H,), 0.0, torch.float32)
    s["dt_bias"] = (None,)
    return p, s


def _causal_conv(u, w, prev=None):
    """Depthwise causal conv. u: (B, S, C); w: (W, C); prev: (B, W-1, C).
    The W shifted windows are summed in order, as the reference sums them."""
    W = w.shape[0]
    if prev is None:
        prev = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    ext = torch.cat([prev, u], dim=1)          # (B, S+W-1, C)
    S = u.shape[1]
    out = sum(ext[:, i:i + S] * w[i] for i in range(W))
    window = ext[:, -(W - 1):] if W > 1 else prev
    return out, window


def mamba2_forward(p, x, cfg, state: Optional[Mamba2State] = None):
    """x: (B, S, d). state None -> chunked scan; else one-step decode."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim

    proj = x @ p["win"]
    z, xbc, dt_pre = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    conv_out, conv_win = _causal_conv(
        xbc, p["conv_w"], None if state is None else state.conv)
    conv_out = F.silu(conv_out)
    xs, Bmat, Cmat = torch.split(conv_out, [di, N, N], dim=-1)
    pre = dt_pre.float() + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))                  # softplus
    A = -torch.exp(p["a_log"])                                        # (H,)
    log_f = dt * A                                                    # (B,S,H)

    xs_h = xs.reshape(B, S, H, P)
    v = xs_h * dt[..., None].to(xs.dtype)                             # dt * x
    k = Bmat[:, :, None, :].expand(B, S, H, N)
    q = Cmat[:, :, None, :].expand(B, S, H, N)
    ones = torch.ones_like(dt)

    if state is None:
        y, ssm = chunked_gated_linear(q, k, v, log_f, ones, cfg.ssm_chunk,
                                      shared_qk=True)
    else:
        ssm, y1 = gated_linear_step(state.ssm, q[:, 0], k[:, 0], v[:, 0],
                                    log_f[:, 0], ones[:, 0])
        y = y1[:, None]
    y = y + xs_h * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, di) * F.silu(z)
    out = y @ p["wout"]
    return out, Mamba2State(conv=conv_win, ssm=ssm)


def mamba2_state(cfg, batch: int, device, lead: tuple = ()) -> Mamba2State:
    H = cfg.d_inner // cfg.ssm_head_dim
    return Mamba2State(
        conv=torch.zeros(lead + (batch, cfg.conv_width - 1,
                                 _conv_channels(cfg)),
                         dtype=torch_dtype(cfg.dtype), device=device),
        ssm=torch.zeros(lead + (batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device),
    )
