"""Mamba2's SSD layer (state-space duality, arXiv:2405.21060), PyTorch
port of ``src/repro/models/ssm.py``.

Train and prefill use the chunked SSD algorithm (quadratic within a
chunk, linear across chunks); decode uses the O(1) recurrence over a
constant-size state. Everything here is plain torch, as the reference
computes it outside any Pallas kernel: the intra-chunk products are
``torch.einsum``/``matmul``, and the reference's inter-chunk
``lax.scan`` is a loop over the chunks in f32.

State layout: h (B, H, P, N) with H heads, P the head dim, N the state
size; the conv state keeps the last K-1 raw channel inputs of each of the
x, B and C streams. A decode (and a prefill given a state) writes the
state's tensors in place, as the port's KV cache is written.

One deliberate difference from the reference: :func:`ssd_chunked` takes
the exponent of the *masked* segment sum, so that its gradient stays
finite at long chunks (see its docstring).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import PD, model_dim_spec, rms_norm


def ssm_template(d, d_inner, n_heads, head_dim, n_state, n_groups, conv_k,
                 stack=None):
    """The reference's SSM parameters, leaf for leaf: the input
    projections (z, x, B, C, dt), the depthwise conv taps of the x, B and
    C streams, ``A_log`` (zeros), ``D`` (ones), ``dt_bias`` (zeros), the
    gated RMSNorm's gain ``norm`` (zeros: a gain of ``1 + norm``) and the
    output projection."""
    ins = model_dim_spec(d_inner)
    gn = n_groups * n_state

    def st(shape, spec, init="normal"):
        if stack is None:
            return PD(shape, init, spec=spec)
        return PD((stack, *shape), init, spec=(None, *spec))

    return {
        "w_z": st((d, d_inner), (None, ins)),
        "w_x": st((d, d_inner), (None, ins)),
        "w_B": st((d, gn), (None, None)),
        "w_C": st((d, gn), (None, None)),
        "w_dt": st((d, n_heads), (None, None)),
        "conv_x": st((conv_k, d_inner), (None, ins)),
        "conv_B": st((conv_k, gn), (None, None)),
        "conv_C": st((conv_k, gn), (None, None)),
        "A_log": st((n_heads,), (None,), "zeros"),
        "D": st((n_heads,), (None,), "ones"),
        "dt_bias": st((n_heads,), (None,), "zeros"),
        "norm": st((d_inner,), (ins,), "zeros"),
        "w_out": st((d_inner, d), (ins, None)),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B, L, C), w (K, C)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + L, :] * w[i][None, None, :]
    return out


def _conv_step(x_t, conv_state, w):
    """One token of the causal conv: x_t (B, C), conv_state (B, K-1, C).
    Returns (y (B, C), the shifted window (B, K-1, C)): a new tensor, so
    a caller may copy it over ``conv_state``, whose shift would otherwise
    read and write overlapping memory."""
    cat = torch.cat([conv_state.to(x_t.dtype), x_t[:, None, :]], dim=1)
    y = torch.einsum("bkc,kc->bc", cat, w)
    return y, cat[:, 1:]


def ssd_chunked(xh, dt, A, Bh, Ch, chunk, h0=None):
    """Chunked SSD scan.

    xh (B, L, H, P), dt (B, L, H), A (H,), Bh/Ch (B, L, H, N). Returns
    (y (B, L, H, P), the final state (B, H, P, N) in f32). ``L`` must be
    a multiple of ``chunk`` (a ``ValueError`` otherwise, where the
    reference asserts).

    The decay matrix within a chunk is ``exp`` of the segment sums
    ``seg[i, j] = cs[i] - cs[j]`` below the diagonal and 0 above it. The
    reference computes ``where(causal, exp(seg), 0)``: above the
    diagonal ``seg`` is a positive sum of decays, which past ~88.7
    overflows ``exp`` to inf; the ``where`` drops it in the forward, but
    its backward sends a zero cotangent into ``exp``'s VJP, 0 * inf =
    NaN, and at the published chunk of 256 every gradient of dt, and so
    of every layer below, is NaN. Here the exponent is taken of the
    masked sum, ``seg.masked_fill(~causal, -inf).exp()``: the forward
    values are the reference's element for element, the gradient is the
    reference's wherever that is finite, and it stays finite at any
    chunk.
    """
    B, L, H, P = xh.shape
    N = Bh.shape[-1]
    if L % chunk != 0:
        raise ValueError(f"ssd_chunked: sequence length {L} is not a "
                         f"multiple of the chunk {chunk}")
    nc, Q = L // chunk, chunk

    dA = dt * A[None, None, :]                         # (B,L,H) negatives
    dtx = xh * dt[..., None]                           # input scaled by dt

    def resh(t):
        return t.reshape(B, nc, Q, *t.shape[2:])

    dA_c, dtx_c, B_c, C_c = resh(dA), resh(dtx), resh(Bh), resh(Ch)
    cs = torch.cumsum(dA_c, dim=2)                     # (B,nc,Q,H)

    # --- intra-chunk (diagonal blocks) --------------------------------
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,Q,Q,H) i-j
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=xh.device))
    Lmat = seg.masked_fill(~causal[None, None, :, :, None],
                           float("-inf")).exp()
    G = torch.einsum("bcqhn,bcshn->bcqsh", C_c, B_c)
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", G * Lmat, dtx_c)

    # --- per-chunk input states ---------------------------------------
    decay_states = torch.exp(cs[:, :, -1:, :] - cs)    # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          B_c * decay_states[..., None], dtx_c)

    # --- inter-chunk recurrence, in f32 -------------------------------
    chunk_decay = torch.exp(cs[:, :, -1, :])           # (B,nc,H)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.to(torch.float32))
    states = states.to(torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                # (B,nc,H,P,N)

    # --- off-diagonal contribution ------------------------------------
    state_decay = torch.exp(cs)                        # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         C_c * state_decay[..., None], h_prev.to(xh.dtype))
    y = (y_diag + y_off).reshape(B, L, H, P)
    return y, h


def _expand_groups(b, n_heads):
    """(B, L, G, N) -> (B, L, H, N) by repeating groups."""
    return torch.repeat_interleave(b, n_heads // b.shape[2], dim=2)


def ssm_forward(p, cfg, x, *, state=None, decode=False):
    """Mamba2 block over x (B, L, d). Returns (out, state).

    * train (``state`` None, not ``decode``): (out, None);
    * prefill (a ``state``, not ``decode``): the chunked scan from
      ``state["h"]`` (zeros for a fresh cache), the final state and the
      last K-1 raw conv inputs written into ``state`` in place;
    * decode (``decode``, L == 1): one step of the recurrence and of the
      conv windows, written into ``state`` in place.
    """
    Bsz, L, d = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    G = cfg.ssm_groups
    d_in = H * P

    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bp = x @ p["w_B"]
    Cp = x @ p["w_C"]
    dt = (x @ p["w_dt"]).to(torch.float32)
    A = -torch.exp(p["A_log"].to(torch.float32))
    D = p["D"].to(torch.float32)

    if decode:
        if L != 1 or state is None:
            raise ValueError("ssm_forward: a decode takes one token and a "
                             "state")
        cx, scx = _conv_step(xs[:, 0], state["conv_x"], p["conv_x"])
        cB, scB = _conv_step(Bp[:, 0], state["conv_B"], p["conv_B"])
        cC, scC = _conv_step(Cp[:, 0], state["conv_C"], p["conv_C"])
        dts = F.softplus(dt[:, 0] + p["dt_bias"][None, :])     # (B,H)
        xh = F.silu(cx).reshape(Bsz, H, P)
        Bh = _expand_groups(F.silu(cB).reshape(Bsz, 1, G, N), H)[:, 0]
        Ch = _expand_groups(F.silu(cC).reshape(Bsz, 1, G, N), H)[:, 0]
        dAe = torch.exp(dts * A[None, :])                      # (B,H)
        h = (state["h"].to(torch.float32) * dAe[:, :, None, None]
             + torch.einsum("bhp,bhn->bhpn",
                            xh.to(torch.float32) * dts[..., None],
                            Bh.to(torch.float32)))
        y = torch.einsum("bhpn,bhn->bhp", h, Ch.to(torch.float32))
        y = y + D[None, :, None] * xh
        y = y.reshape(Bsz, 1, d_in).to(x.dtype)
        for k, v in (("h", h), ("conv_x", scx), ("conv_B", scB),
                     ("conv_C", scC)):
            state[k].copy_(v)
    else:
        K = p["conv_x"].shape[0]
        raw = (xs, Bp, Cp)
        xs = F.silu(_causal_conv(xs, p["conv_x"]))
        Bp = F.silu(_causal_conv(Bp, p["conv_B"]))
        Cp = F.silu(_causal_conv(Cp, p["conv_C"]))
        dts = F.softplus(dt + p["dt_bias"][None, None, :])
        xh = xs.reshape(Bsz, L, H, P)
        Bh = _expand_groups(Bp.reshape(Bsz, L, G, N), H)
        Ch = _expand_groups(Cp.reshape(Bsz, L, G, N), H)
        h0 = None if state is None else state["h"]
        y, hT = ssd_chunked(xh.to(torch.float32), dts, A,
                            Bh.to(torch.float32), Ch.to(torch.float32),
                            cfg.ssm_chunk, h0)
        y = y + D[None, None, :, None] * xh
        y = y.reshape(Bsz, L, d_in).to(x.dtype)
        if state is not None:
            state["h"].copy_(hT)
            for k, r in zip(("conv_x", "conv_B", "conv_C"), raw):
                state[k].copy_(r[:, -(K - 1):, :])

    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"])
    return y @ p["w_out"], state


def init_ssm_state(cfg, batch, dtype=torch.float32, device=None):
    """A zeroed state of one layer: {"h", "conv_x", "conv_B", "conv_C"}."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gn, K = cfg.ssm_groups * N, cfg.conv_kernel
    shapes = {"h": (batch, H, P, N), "conv_x": (batch, K - 1, H * P),
              "conv_B": (batch, K - 1, gn), "conv_C": (batch, K - 1, gn)}
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in shapes.items()}
