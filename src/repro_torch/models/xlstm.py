"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM.

The counterpart of ``repro.models.xlstm``. mLSTM (matrix memory) per head h
with dim dh:

    C_t = f_t C_{t-1} + i_t k_t v_t^T        (dh x dh matrix memory)
    y_t = C_t^T q_t

computed chunkwise (intra-chunk quadratic with a decay matrix, the state
carried across chunks by a Python loop where JAX scans) by
``chunked_gated_linear``, which Mamba2's SSD shares. The same
simplifications as the reference: a sigmoid input gate and no key
normalizer. sLSTM (scalar memory) is strictly recurrent over time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamInit, dense_param, torch_dtype


# ---------------------------------------------------------------------------
# Shared chunked gated linear attention (used by mLSTM and Mamba2 SSD)
# ---------------------------------------------------------------------------

def chunked_gated_linear(q, k, v, log_f, i_gate, chunk: int,
                         shared_qk: bool = False):
    """y_t = sum_{j<=t} (prod_{r=j+1..t} f_r) i_j (q_t . k_j) v_j, chunked.

    q, k: (B, S, H, dk); v: (B, S, H, dv); log_f, i_gate: (B, S, H).
    Returns (y (B,S,H,dv), final_state (B,H,dk,dv) float32).

    ``shared_qk``: q/k arrive head-broadcast (Mamba2's B/C projections), so
    the intra-chunk score matmul is computed once per chunk, not per head.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    if S % c:
        c = S
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for lo in range(0, S, c):
        sl = slice(lo, lo + c)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        fc, ic = log_f[:, sl], i_gate[:, sl]        # (B, c, H)
        Fc = torch.cumsum(fc, dim=1)                # (B, c, H) log decay
        # intra-chunk: D[t, j] = exp(F_t - F_j) * i_j  for j <= t
        dmat = Fc[:, :, None, :] - Fc[:, None, :, :]  # (B, c, c, H)
        dmat = dmat.masked_fill(~tri[None, :, :, None], -math.inf)
        gates = torch.exp(dmat) * ic[:, None, :, :]   # (B, c(t), c(j), H)
        if shared_qk:
            scores = torch.einsum("btd,bjd->btj", qc[:, :, 0],
                                  kc[:, :, 0])[..., None]
        else:
            scores = torch.einsum("bthd,bjhd->btjh", qc, kc)
        intra = torch.einsum("btjh,bjhv->bthv", scores * gates, vc)
        # inter-chunk: y += exp(F_t) * q_t . state
        inter = torch.einsum("bthd,bhdv->bthv",
                             qc * torch.exp(Fc)[..., None], state)
        # state' = exp(F_c) * state + sum_j exp(F_c - F_j) i_j k_j v_j^T
        last = Fc[:, -1:, :]                        # (B, 1, H)
        carry_gate = torch.exp(last - Fc) * ic      # (B, c, H)
        upd = torch.einsum("bjh,bjhd,bjhv->bhdv", carry_gate, kc, vc)
        state = torch.exp(last[:, 0, :])[..., None, None] * state + upd
        ys.append(intra + inter)
    y = torch.cat(ys, dim=1)
    return y.to(v.dtype), state


def gated_linear_step(state, q, k, v, log_f, i_gate):
    """Single-token recurrent step. state: (B,H,dk,dv); q/k/v: (B,H,d*)."""
    f = torch.exp(log_f)[..., None, None].float()
    upd = torch.einsum("bhd,bhv->bhdv", k.float(),
                       v.float()) * i_gate[..., None, None]
    state = f * state + upd
    y = torch.einsum("bhdv,bhd->bhv", state, q.float())
    return state, y.to(v.dtype)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def init_mlstm(init: ParamInit, cfg, ctx):
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["wqkv"], s["wqkv"] = dense_param(init, d, 3 * di, ctx, dt)
    p["wgate"], s["wgate"] = dense_param(init, d, 2 * H, ctx, dt, scale=0.02)
    p["wout"], s["wout"] = dense_param(init, di, d, ctx, dt, tp_dim="in")
    return p, s


def mlstm_forward(p, x, cfg, state=None):
    """x: (B, S, d). state None -> chunked parallel; else one-step decode."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = cfg.d_inner
    dh = di // H
    qkv = x @ p["wqkv"]
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(B, S, H, dh)
    # JAX divides by sqrt(dh) rounded to the activations' dtype
    k = k.reshape(B, S, H, dh) / torch.tensor(math.sqrt(dh), dtype=x.dtype,
                                              device=x.device)
    v = v.reshape(B, S, H, dh)
    gates = (x @ p["wgate"]).float()
    log_f = F.logsigmoid(gates[..., :H])
    i_gate = torch.sigmoid(gates[..., H:])
    if state is None:
        y, fin = chunked_gated_linear(q, k, v, log_f, i_gate, cfg.ssm_chunk)
    else:
        fin, y1 = gated_linear_step(state, q[:, 0], k[:, 0], v[:, 0],
                                    log_f[:, 0], i_gate[:, 0])
        y = y1[:, None]
    out = y.reshape(B, S, di) @ p["wout"]
    return out, fin


# ---------------------------------------------------------------------------
# sLSTM block (recurrent scalar memory)
# ---------------------------------------------------------------------------

def init_slstm(init: ParamInit, cfg, ctx):
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p, s = {}, {}
    p["wx"], s["wx"] = dense_param(init, d, 4 * d, ctx, dt)
    p["wh"], s["wh"] = dense_param(init, d, 4 * d, ctx, dt, scale=0.02)
    return p, s


def slstm_forward(p, x, cfg, state=None):
    """x: (B, S, d); recurrent over S. state = (c, h) each (B, d) float32."""
    B, S, d = x.shape
    xg = x @ p["wx"]                       # (B, S, 4d)
    if state is None:
        c = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        h = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    else:
        c, h = state
    ys = []
    for t in range(S):
        g = (xg[:, t] + h.to(xg.dtype) @ p["wh"]).float()
        i, f, z, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    y = torch.stack(ys, dim=1).to(x.dtype)   # (B, S, d)
    return y, (c, h)

