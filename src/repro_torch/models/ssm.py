"""Mamba2 SSD (state-space duality) block: chunked train/prefill + O(1)
decode (counterpart of ``repro.models.ssm``).

``ssd_chunked`` is the port of the reference's default path: intra-chunk
quadratic term, chunk states, and the inter-chunk recurrence as a loop over
chunks (the reference's ``lax.scan``), with the reference's bfloat16
roundings of the einsum operands.  The prefill's kernel route
(``Variant.use_pallas``) goes to ``repro_torch.kernels.ssd_scan`` instead
(``ssd_kernel_route``).  Projections are split per stream (z/x/B/C/dt).
``mamba_prefill`` is one whole Mamba layer of a prefill, shared by the
hybrid and the ssm-only model; ``ssm_block`` is the block for training,
always on ``ssd_chunked`` (the kernel is forward only).

On a mesh (a ``sharding.TP`` plan) the layer runs on the rank's SSD heads:
``w_z``, ``w_x``, ``conv_x``, ``w_dt``, ``A_log``, ``D``, ``dt_bias`` and
``gate_norm`` arrive as its ``model`` blocks (inner and heads), ``w_B``,
``w_C``, ``conv_B`` and ``conv_C`` whole (their axis is ``state``, and the
one group serves every head); the gated RMS norm runs over the whole
``d_inner``, its sum of squares summed over ``model``, and ``w_out``'s row
block gives a partial sum that ``TP.reduce`` sums over ``model``.  The
decode cache is the rank's block too: ``state`` by heads, ``conv_x`` by
inner.  ``keep_model`` says whether a layer's leaves keep their ``model``
block (``heads`` and ``inner`` both split, or both whole).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import NO_TP, TP_AXIS
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import (ParamSpec, apply_norm, cast_compute,
                                       rms_norm)


def ssm_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return d_in, n_heads


def ssm_specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, H = ssm_dims(cfg)
    GN = s.n_groups * s.d_state
    return {
        "w_z": ParamSpec((d, d_in), ("embed", "inner")),
        "w_x": ParamSpec((d, d_in), ("embed", "inner")),
        "w_B": ParamSpec((d, GN), ("embed", "state")),
        "w_C": ParamSpec((d, GN), ("embed", "state")),
        "w_dt": ParamSpec((d, H), ("embed", "heads")),
        "conv_x": ParamSpec((s.conv_width, d_in), ("conv", "inner"), "normal", 0.5),
        "conv_B": ParamSpec((s.conv_width, GN), ("conv", "state"), "normal", 0.5),
        "conv_C": ParamSpec((s.conv_width, GN), ("conv", "state"), "normal", 0.5),
        "A_log": ParamSpec((H,), ("heads",), "zeros"),   # A = -exp(A_log) = -1
        "D": ParamSpec((H,), ("heads",), "ones"),
        "dt_bias": ParamSpec((H,), ("heads",), "zeros"),
        "gate_norm": ParamSpec((d_in,), ("inner",), "ones"),
        "w_out": ParamSpec((d_in, d), ("inner", "embed")),
    }


def keep_model(cfg, tp) -> tuple[str, ...]:
    """The mesh axes a Mamba layer's leaves keep as blocks when gathered
    (``gather_tree``'s ``keep``): ``model``, unless the rules split the
    SSD heads and the inner dim differently (then the layer is gathered
    whole and computed whole on every rank)."""
    d_in, H = ssm_dims(cfg)
    if tp.splits("heads", H) != tp.splits("inner", d_in):
        return ()
    return (TP_AXIS,)


def _gated_norm(cfg, y, w, tp):
    """``rms_norm`` over the whole ``d_inner`` of the rank's block ``y``
    (B, S, d_local): the sum of squares summed over ``model`` where
    ``y`` is a block."""
    d_in, _ = ssm_dims(cfg)
    if y.shape[-1] == d_in:
        return rms_norm(y, w, cfg.norm_eps)
    yf = y.to(torch.float32)
    var = tp.sum(torch.sum(yf * yf, dim=-1, keepdim=True)) / d_in
    out = yf * torch.rsqrt(var + cfg.norm_eps) * w.to(torch.float32)
    return out.to(y.dtype)


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), not ``F.softplus``, whose
    threshold returns x itself above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, prepend=None):
    """Depthwise causal conv.  x: (B, S, C); w: (W, C); prepend: (B, W-1, C)|None.
    Products and sums in x's dtype, in the reference's order."""
    W = w.shape[0]
    if prepend is None:
        prepend = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([prepend, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i][None, None, :]
    return out


def _project(cfg, p, x):
    """x: (B,S,D) -> z, xh (B,S,H,P), Bm/Cm (B,S,G,N), dt (B,S,H) [post
    conv+act]; H the heads of ``p``'s blocks."""
    s = cfg.ssm
    H = p["w_dt"].shape[-1]
    xc = cast_compute(x)
    z = xc @ cast_compute(p["w_z"])
    xs = xc @ cast_compute(p["w_x"])
    Bs = xc @ cast_compute(p["w_B"])
    Cs = xc @ cast_compute(p["w_C"])
    dt = (xc @ cast_compute(p["w_dt"])).to(torch.float32)
    xs = F.silu(_causal_conv(xs, cast_compute(p["conv_x"])).to(torch.float32)).to(xc.dtype)
    Bs = F.silu(_causal_conv(Bs, cast_compute(p["conv_B"])).to(torch.float32)).to(xc.dtype)
    Cs = F.silu(_causal_conv(Cs, cast_compute(p["conv_C"])).to(torch.float32)).to(xc.dtype)
    B, S, _ = x.shape
    xh = xs.reshape(B, S, H, s.head_dim)
    Bm = Bs.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cs.reshape(B, S, s.n_groups, s.d_state)
    dt = softplus(dt + p["dt_bias"].to(torch.float32))
    return z, xh, Bm, Cm, dt


def _bf16_f32(x):
    """x rounded to bfloat16, held in float32 (a bf16 einsum operand whose
    products and sums run in f32, as ``preferred_element_type=f32``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """SSD forward.  xh: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32 (negative);
    Bm/Cm: (B,S,G,N).  Returns y: (B,S,H,P) f32 and final state (B,H,P,N)."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    HG = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {Q}")
    nc = S // Q
    dev = xh.device

    xdt = (xh.to(torch.float32) * dt[..., None]).to(xh.dtype)      # dt-weighted input
    dA = dt * A[None, None, :]                                     # (B,S,H) f32, <=0

    # chunk views
    xc = xdt.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, G, N)
    Cc = Cm.reshape(B, nc, Q, G, N)
    dAc = dA.reshape(B, nc, Q, H)
    cum = torch.cumsum(dAc, dim=2)                                 # (B,nc,Q,H)

    # --- intra-chunk (quadratic, per chunk) ---
    CB = torch.einsum("bcign,bcjgn->bcgij", _bf16_f32(Cc), _bf16_f32(Bc))  # (B,nc,G,Q,Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B,nc,Qi,Qj,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    L = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), device=dev))                   # (B,nc,Qi,Qj,H)
    CBh = CB.repeat_interleave(HG, dim=2) if G > 1 else CB.expand(B, nc, H, Q, Q)
    M = CBh * L.permute(0, 1, 4, 2, 3)                             # (B,nc,H,Qi,Qj)
    y_diag = torch.einsum("bchij,bcjhp->bcihp",
                          M.to(xc.dtype).to(torch.float32), xc.to(torch.float32))

    # --- chunk states ---
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(HG, dim=3) if G > 1 else Bc.expand(B, nc, Q, H, N)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", _bf16_f32(Bh),
                          _bf16_f32(decay_out), xc.to(torch.float32))  # (B,nc,H,P,N)

    # --- inter-chunk recurrence (serial over nc chunks) ---
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    prev = []
    for c in range(nc):
        prev.append(h)                                             # state *entering* chunk
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                                # (B,nc,H,P,N)

    # --- off-diagonal contribution ---
    Ch = Cc.repeat_interleave(HG, dim=3) if G > 1 else Cc.expand(B, nc, Q, H, N)
    decay_in = torch.exp(cum)                                      # (B,nc,Q,H)
    y_off = torch.einsum("bcihn,bchpn,bcih->bcihp", _bf16_f32(Ch),
                         _bf16_f32(prev), _bf16_f32(decay_in))
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, h


def ssd_kernel_route(xh, dt, A, Bm, Cm, chunk: int):
    """The same function through the hand-written SSD kernel
    (``repro_torch.kernels.ssd_scan.ops.ssd``), as ``Variant.use_pallas``
    takes it: ``xdt`` and ``dA`` built as ``ssd_chunked`` builds them, laid
    out per head ``(B*H, S, ·)`` as the reference's own mapping test lays
    them out, B and C passed as stride-0 views over the heads of their group
    (no per-head copy).  Returns y (B,S,H,P) f32 and the final state
    (B,H,P,N), as ``ssd_chunked``."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xdt = (xh.to(torch.float32) * dt[..., None]).to(xh.dtype)
    dA = dt * A[None, None, :]
    # contiguous: at B == 1 the reshape is a view with the permuted strides
    xk = xdt.permute(0, 2, 1, 3).reshape(B * H, S, P).contiguous()
    dAk = dA.permute(0, 2, 1).reshape(B * H, S).contiguous()

    def per_head(m):                                 # (B,S,G,N) -> (B,H,S,N)
        if G == 1:
            return m[:, :, 0].unsqueeze(1).expand(B, H, S, N)
        return m.permute(0, 2, 1, 3).repeat_interleave(H // G, dim=1)

    y, st = ssd_ops.ssd(xk, dAk, per_head(Bm), per_head(Cm), chunk=chunk)
    y = y.reshape(B, H, S, P).permute(0, 2, 1, 3).to(torch.float32)
    return y, st.reshape(B, H, N, P).transpose(-1, -2)


def _gated_out(cfg, p, x, y, z, xh, tp=NO_TP):
    """The block's tail from the SSD's y: the D skip, the SiLU gate, the
    gated RMS norm and the output projection, (B, S, D) in x's dtype (the
    residual stream's block under ``tp``)."""
    B, S, H, P = xh.shape
    y = y + p["D"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, S, H * P)
    y = y.to(torch.float32) * F.silu(z.to(torch.float32))
    y = _gated_norm(cfg, y.to(x.dtype), p["gate_norm"], tp)
    return tp.row(cast_compute(y), cast_compute(p["w_out"]),
                  H < ssm_dims(cfg)[1], x.dtype)


def ssm_block(cfg, p: dict, x, tp=NO_TP):
    """The Mamba2 block for training, x (B, S, D) -> (B, S, D): the block
    output only, no cache, its SSD through ``ssd_chunked``.  Under ``tp``
    x and the output are the residual stream's block."""
    z, xh, Bm, Cm, dt = _project(cfg, p, tp.gather_seq(x))
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm.chunk_size)
    return _gated_out(cfg, p, x, y, z, xh, tp)


def mamba_prefill(cfg, p, x, variant, tp=NO_TP):
    """One Mamba layer ``{"ln", "ssm"}`` over the whole prompt, residual
    included (the layer the reference writes out twice, in ``HybridLM`` and
    ``SSMLM``'s prefill); the SSD through the hand-written kernel where
    ``variant.use_pallas``, else ``ssd_chunked``.  Returns (x + the layer's
    output, its decode cache: the rank's block under ``tp``)."""
    h = tp.gather_seq(apply_norm(cfg, p["ln"], x))
    S = h.shape[1]
    z, xh, Bm, Cm, dt = _project(cfg, p["ssm"], h)
    A = -torch.exp(p["ssm"]["A_log"].to(torch.float32))
    ssd = ssd_kernel_route if variant.use_pallas else ssd_chunked
    y, state = ssd(xh, dt, A, Bm, Cm, cfg.ssm.chunk_size)
    out = x + _gated_out(cfg, p["ssm"], x, y, z, xh, tp)
    W = cfg.ssm.conv_width
    # conv caches: last W-1 *pre-activation* conv inputs
    xc = cast_compute(h)[:, S - (W - 1):, :]
    entry = {
        "state": state,
        "conv_x": xc @ cast_compute(p["ssm"]["w_x"]),
        "conv_B": xc @ cast_compute(p["ssm"]["w_B"]),
        "conv_C": xc @ cast_compute(p["ssm"]["w_C"]),
    }
    return out, entry


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def ssm_cache_shapes(cfg, batch: int):
    """name -> (shape, logical axes, dtype) of one Mamba layer's decode
    cache."""
    s = cfg.ssm
    d_in, H = ssm_dims(cfg)
    GN = s.n_groups * s.d_state
    W = s.conv_width
    return {
        "state": ((batch, H, s.head_dim, s.d_state),
                  ("batch", "heads", None, None), torch.float32),
        "conv_x": ((batch, W - 1, d_in), ("batch", None, "inner"),
                   torch.bfloat16),
        "conv_B": ((batch, W - 1, GN), ("batch", None, "state"),
                   torch.bfloat16),
        "conv_C": ((batch, W - 1, GN), ("batch", None, "state"),
                   torch.bfloat16),
    }


def ssm_decode(cfg, p: dict, x, cache: dict, tp=NO_TP):
    """x: (B,1,D); cache: dict of state/conv_x/conv_B/conv_C (the rank's
    heads and inner block under ``tp``).  Returns (y, cache)."""
    s = cfg.ssm
    H = p["w_dt"].shape[-1]
    d_in = H * s.head_dim
    B = x.shape[0]
    xc = cast_compute(x)
    z = xc @ cast_compute(p["w_z"])
    xs = xc @ cast_compute(p["w_x"])
    Bs = xc @ cast_compute(p["w_B"])
    Cs = xc @ cast_compute(p["w_C"])
    dt = (xc @ cast_compute(p["w_dt"])).to(torch.float32)

    def conv_step(val, w, prev):  # val (B,1,C), prev (B,W-1,C)
        window = torch.cat([prev, val.to(prev.dtype)], dim=1)     # (B,W,C)
        out = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                           w.to(torch.float32))[:, None, :]
        return F.silu(out).to(val.dtype), window[:, 1:]

    xs, conv_x = conv_step(xs, p["conv_x"], cache["conv_x"])
    Bs, conv_B = conv_step(Bs, p["conv_B"], cache["conv_B"])
    Cs, conv_C = conv_step(Cs, p["conv_C"], cache["conv_C"])

    xh = xs.reshape(B, H, s.head_dim)
    Bm = Bs.reshape(B, s.n_groups, s.d_state)
    Cm = Cs.reshape(B, s.n_groups, s.d_state)
    HG = H // s.n_groups
    Bh = Bm.repeat_interleave(HG, dim=1)                           # (B,H,N)
    Ch = Cm.repeat_interleave(HG, dim=1)
    dt = softplus(dt[:, 0] + p["dt_bias"].to(torch.float32))       # (B,H)
    A = -torch.exp(p["A_log"].to(torch.float32))
    dA = torch.exp(dt * A[None, :])                                # (B,H)

    state = cache["state"]
    state = state * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xh.to(torch.float32), Bh.to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(torch.float32))
    y = y + p["D"].to(torch.float32)[None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, 1, d_in)
    y = y * F.silu(z.to(torch.float32))
    y = _gated_norm(cfg, y.to(x.dtype), p["gate_norm"], tp)
    out = tp.row(cast_compute(y), cast_compute(p["w_out"]),
                 H < ssm_dims(cfg)[1], x.dtype)
    new_cache = {"state": state, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}
    return out, new_cache
