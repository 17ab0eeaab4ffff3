"""Selective state-space blocks (the port of ``repro.models.ssm``): Mamba-1
(falcon-mamba) and the multi-head scalar-decay Mamba-2 (zamba2's
backbone, the JAX package's SSD simplification: scalar decay per head,
shared B/C of width ``d_state``).

A full sequence runs the recurrence ``h_t = a_t * h_{t-1} + b_t`` as a
log-depth doubling scan of the JAX package's associative ``combine`` in
torch ops (:func:`_ssm_scan`); decode is the O(1) single-step update
carrying ``(conv_state, ssm_state)``.  The (B, S, ..., N) float32
transients of a full sequence are built, scanned and contracted a group
of batch rows at a time, each tensor at most ``SCAN_BYTES`` (the rows are
independent, so the result is the same).

Training differentiates the scan through :class:`SSMScan`, whose backward
is the adjoint recurrence run as the same doubling scan backwards in time
(:func:`_reverse_scan`): it keeps ``a`` and the output ``h``, never one
buffer per pass.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Spec

# Largest float32 (B, S, ..., N) tensor of one row group (zamba2 at 4 x 2048
# would take 10.7 GB a tensor for the whole batch, falcon-mamba 4.3 GB).
SCAN_BYTES = 4 << 30


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba1_specs(cfg: ModelConfig) -> dict:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    r = _dt_rank(cfg)
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "inner")),
        "conv_w": Spec((k, di), (None, "inner")),
        "conv_b": Spec((di,), ("inner",), "zeros"),
        "x_proj": Spec((di, r + 2 * n), ("inner", None)),
        "dt_proj": Spec((r, di), (None, "inner")),
        "dt_bias": Spec((di,), ("inner",), "zeros"),
        "A_log": Spec((di, n), ("inner", None), "ones"),
        "D": Spec((di,), ("inner",), "ones"),
        "out_proj": Spec((di, d), ("inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B,S,C); w: (K,C): ``F.conv1d`` with
    ``groups=C`` (a cross-correlation, as ``conv_general_dilated``) over
    the input left-padded with K-1 zeros."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    out = F.conv1d(xp, w.t()[:, None, :], groups=c)
    return out.transpose(1, 2) + b


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1; returns all h_t.

    The JAX package's ``associative_scan`` of ``combine((al, bl), (ar,
    br)) = (al * ar, br + ar * bl)`` as a doubling scan: pass j combines
    each element with the one 2^j before it (the identity (1, 0) before
    the start), ceil(log2 S) passes, so the sums group like a tree.  ``a``
    may broadcast against ``b`` after axis 1.  Each pass writes one of two
    buffers (the inputs are only read); ``a`` is not combined in the last
    pass, which needs only ``b``."""
    s = b.shape[1]
    bufs_a = [torch.empty_like(a), torch.empty_like(a)] if s > 2 else []
    bufs_b = [torch.empty_like(b), torch.empty_like(b)] if s > 1 else []
    shift, j = 1, 0
    while shift < s:
        nb = bufs_b[j % 2]
        nb[:, :shift] = b[:, :shift]
        torch.addcmul(b[:, shift:], a[:, shift:], b[:, :-shift],
                      out=nb[:, shift:])
        if 2 * shift < s:
            na = bufs_a[j % 2]
            na[:, :shift] = a[:, :shift]
            torch.mul(a[:, :-shift], a[:, shift:], out=na[:, shift:])
            a = na
        b = nb
        shift, j = 2 * shift, j + 1
    return b


def _reverse_scan(a: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_doubling_scan`: ``g_t = gh_t + a_{t+1} *
    g_{t+1}`` with ``g_{S-1} = gh_{S-1}``, all g_t.

    The same doubling scan mirrored in time: pass j combines each element
    with the one 2^j after it, the decays ``ae_t`` (initially
    ``a_{t+1}``, a view of ``a`` from position 1, so ``a_0`` is never
    read) multiplied pairwise as they go.  Two buffers for ``g`` and two
    one position shorter for the decays; the inputs are only read."""
    s = gh.shape[1]
    ae = a[:, 1:]
    bufs_a = [torch.empty_like(ae), torch.empty_like(ae)] if s > 2 else []
    bufs_g = [torch.empty_like(gh), torch.empty_like(gh)] if s > 1 else []
    g = gh
    shift, j = 1, 0
    while shift < s:
        ng = bufs_g[j % 2]
        ng[:, s - shift:] = g[:, s - shift:]
        torch.addcmul(g[:, :s - shift], ae[:, :s - shift], g[:, shift:],
                      out=ng[:, :s - shift])
        if 2 * shift < s:
            na = bufs_a[j % 2]
            torch.mul(ae[:, :s - 2 * shift], ae[:, shift:s - shift],
                      out=na[:, :s - 2 * shift])
            ae = na
        g = ng
        shift, j = 2 * shift, j + 1
    return g


class SSMScan(torch.autograd.Function):
    """:func:`_doubling_scan` with a backward: the gradient ``g`` of the
    states is the reverse scan of the incoming gradient ``gh``
    (:func:`_reverse_scan`); then ``db = g`` and ``da_t = g_t *
    h_{t-1}`` (``h_{-1} = 0``), summed back to ``a``'s broadcast shape.
    It saves ``a`` and the output ``h``."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        ctx.b_shape = b.shape
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        g = _reverse_scan(a, gh.contiguous())
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros_like(a)
            if h.shape[1] > 1:
                da[:, 1:] = (g[:, 1:] * h[:, :-1]).sum_to_size(da[:, 1:].shape)
        if ctx.needs_input_grad[1]:
            db = g.sum_to_size(ctx.b_shape)
        return da, db


def _ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1; returns all h_t
    (:func:`_doubling_scan`).  Where autograd records (grad mode on and an
    input that requires grad) it runs as :class:`SSMScan`; otherwise, as
    in serving, the doubling scan alone, which saves nothing."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return SSMScan.apply(a, b)
    return _doubling_scan(a, b)


def _by_rows(fn, b: int, row_bytes: int):
    """``fn(rows)`` → (y, h_last) over groups of batch rows whose float32
    transients stay within ``SCAN_BYTES`` a tensor, concatenated."""
    n = max(1, min(b, SCAN_BYTES // max(row_bytes, 1)))
    parts = [fn(slice(i, i + n)) for i in range(0, b, n)]
    return (torch.cat([y for y, _ in parts]),
            torch.cat([h for _, h in parts]))


def _conv_window(xs, p, state, k: int, return_state: bool):
    """The causal conv of the pre-conv inputs ``xs`` (B,S,di) and the conv
    state for later decode steps: in full-sequence mode the last K-1
    inputs (zero-padded in front when S < K-1) if ``return_state``; in
    decode the window over ``state``'s K-1 inputs and the new one."""
    b, s, di = xs.shape
    if state is None:
        new_conv = None
        if return_state:
            pad = torch.zeros((b, max(0, (k - 1) - s), di), dtype=xs.dtype,
                              device=xs.device)
            new_conv = torch.cat([pad, xs[:, -(k - 1):, :]], dim=1)
        return _causal_conv(xs, p["conv_w"], p["conv_b"]), new_conv
    conv_state = state[0]
    window = torch.cat([conv_state, xs], dim=1)  # (B, K, di) for S=1
    out = torch.einsum("bkc,kc->bc", window[:, -k:], p["conv_w"])
    return out[:, None, :] + p["conv_b"], window[:, -(k - 1):, :]


def mamba1(p: dict, x: torch.Tensor, cfg: ModelConfig,
           state: tuple | None = None, return_state: bool = False):
    """x: (B,S,d).  state (decode): (conv_state (B,K-1,di), h (B,di,N)).

    Returns (y, new_state).  ``return_state=True`` in full-sequence mode
    extracts the final (conv, h) state — the SSM prefill path.
    """
    b, s, d = x.shape
    di, n, k = cfg.d_inner, cfg.d_state, cfg.d_conv
    r = _dt_rank(cfg)

    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, new_conv = _conv_window(xs, p, state, k, return_state)
    xs = F.silu(xs)

    proj = torch.einsum("bsc,ce->bse", xs, p["x_proj"])
    dt_r, bc, cc = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(torch.einsum("bsr,rc->bsc", dt_r, p["dt_proj"])
                    + p["dt_bias"])
    a_mat = -torch.exp(p["A_log"].to(torch.float32))  # (di, N)

    def terms(rows):
        decay = torch.exp(dt[rows, ..., None].to(torch.float32) * a_mat)
        drive = (dt[rows, ..., None] * bc[rows, :, None, :]
                 * xs[rows, ..., None]).to(torch.float32)
        return decay, drive                                  # (B,S,di,N)

    if state is None:
        def rows_out(rows):
            h = _ssm_scan(*terms(rows))
            y = torch.einsum("bsdn,bsn->bsd", h.to(x.dtype), cc[rows])
            return y, h[:, -1].clone()

        y, h_last = _by_rows(rows_out, b, s * di * n * 4)
        new_h = h_last if return_state else None
    else:
        decay, drive = terms(slice(None))
        h = decay * state[1][:, None] + drive
        new_h = h[:, 0]
        y = torch.einsum("bsdn,bsn->bsd", h.to(x.dtype), cc)

    y = y + p["D"] * xs
    y = y * F.silu(z)
    out = torch.einsum("bsc,cd->bsd", y, p["out_proj"])
    new_state = None if new_h is None else (new_conv, new_h)
    return out, new_state


def mamba2_specs(cfg: ModelConfig) -> dict:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    nh = cfg.ssm_heads
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "inner")),
        "conv_w": Spec((k, di), (None, "inner")),
        "conv_b": Spec((di,), ("inner",), "zeros"),
        "bc_proj": Spec((d, 2 * n), ("embed", None)),
        "dt_proj": Spec((d, nh), ("embed", None)),
        "dt_bias": Spec((nh,), (None,), "zeros"),
        "A_log": Spec((nh,), (None,), "ones"),
        "D": Spec((di,), ("inner",), "ones"),
        "out_proj": Spec((di, d), ("inner", "embed")),
    }


def _mamba2_heads(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_in: torch.Tensor, c_out: torch.Tensor,
                  h0: torch.Tensor | None, hd: int, return_state: bool):
    """The per-head step of :func:`mamba2`: the scan over a full sequence
    (``h0`` None) or one recurrence step from ``h0`` (B,NH,HD,N), then the
    read-out ``"bshdn,bsn->bshd"``.  xs: (B,S,NH*HD) in heads of ``hd``
    channels; dt: (B,S,NH); a: (NH,) float32; b_in, c_out: (B,S,N).
    Returns y (B,S,NH*HD) in xs's dtype and the last state (B,NH,HD,N),
    None for a full sequence unless ``return_state``.  Each channel's
    recurrence reads only its own head's ``dt`` and ``a``, so a contiguous
    block of channels runs as heads of one channel (the dry run's split
    plan, ``launch/dryrun._split_mamba2_heads``)."""
    b, s, di = xs.shape
    nh, n = di // hd, b_in.shape[-1]
    xh = xs.reshape(b, s, nh, hd)
    decay = torch.exp(dt.to(torch.float32) * a)               # (B,S,NH)

    def drive(rows):                                          # (B,S,NH,HD,N)
        return (dt[rows, ..., None, None] * xh[rows, ..., None]
                * b_in[rows, :, None, None, :]).to(torch.float32)

    if h0 is None:
        def rows_out(rows):
            h = _ssm_scan(decay[rows, ..., None, None], drive(rows))
            y = torch.einsum("bshdn,bsn->bshd", h.to(xs.dtype), c_out[rows])
            return y, h[:, -1].clone()

        y, h_last = _by_rows(rows_out, b, s * nh * hd * n * 4)
        new_h = h_last if return_state else None
    else:
        h = decay[..., None, None] * h0[:, None] + drive(slice(None))
        new_h = h[:, 0]
        y = torch.einsum("bshdn,bsn->bshd", h.to(xs.dtype), c_out)
    return y.reshape(b, s, di), new_h


def mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig,
           state: tuple | None = None, return_state: bool = False):
    """Multi-head scalar-decay SSD block.  state: (conv (B,K-1,di), h
    (B,NH,HD,N))."""
    di, k = cfg.d_inner, cfg.d_conv
    hd = di // cfg.ssm_heads

    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, new_conv = _conv_window(xs, p, state, k, return_state)
    xs = F.silu(xs)

    bc = torch.einsum("bsd,dn->bsn", x, p["bc_proj"])
    b_in, c_out = torch.chunk(bc, 2, dim=-1)                  # (B,S,N) each
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, p["dt_proj"])
                    + p["dt_bias"])
    a = -torch.exp(p["A_log"].to(torch.float32))              # (NH,)

    h0 = None if state is None else state[1]
    y, new_h = _mamba2_heads(xs, dt, a, b_in, c_out, h0, hd, return_state)
    y = y + p["D"] * xs
    y = y * F.silu(z)
    out = torch.einsum("bsc,cd->bsd", y, p["out_proj"])
    new_state = None if new_h is None else (new_conv, new_h)
    return out, new_state
