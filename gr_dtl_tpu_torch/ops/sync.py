"""Schmidl-Cox synchronization: timing metric, trigger detection, CFO
(port of gr_dtl_tpu/ops/sync.py).

The timing metric for the whole stream is computed at once, candidate
triggers are found by folding the metric over the known frame period
(every frame votes for the common phase), and per-frame refinement picks
the local plateau centroid.

Frame timing geometry: sync word 1 occupies even carriers only, so its
64-sample useful part repeats with period 32.  With the cyclic prefix
the repetition spans samples [frame_start, frame_start+80) and the metric

    P(d) = sum_{m<32} conj(r[d+m]) r[d+m+32],   M(d) = |P|^2 / (R1 R2)

(R1/R2 = first/second half-window energies; Cauchy-Schwarz keeps
M <= 1 even on idle air and signal edges) has a plateau for d in
[frame_start, frame_start+cp_len].  The fine (fractional-carrier) CFO
is angle(P)/pi in subcarrier units.

The reference picks between a periodic fast path and a per-window
gather with ``lax.cond``.  Here both branches' window *start indices*
are computed and ``torch.where`` picks one set on the device, followed
by one gather: no host round trip decides the branch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.ops import sync_cuda

__all__ = [
    "timing_metric",
    "fold_detect",
    "phase_from_folded",
    "frame_triggers",
    "fine_cfo",
    "cfo_correct",
    "extract_windows",
    "extract_frames",
    "extract_frames_batch",
    "fine_cfo_batch",
]


def _rows(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """[len(starts), length] windows x[starts[i] : starts[i] + length]
    (starts already in range), as one gather."""
    return x[starts[:, None] + torch.arange(length, device=x.device)]


def _median_trunc(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=-1).astype(int32)`` of integers: for an even
    count the mean of the two middle values, truncated toward zero.
    (``torch.median`` would return the lower middle value.)"""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return torch.div(s[..., (n - 1) // 2] + s[..., n // 2], 2, rounding_mode="trunc")


def _rows_batch(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """[S, B, length] windows x[s, starts[s, i] : + length] of [S, N] rows
    (starts already in range), as one gather."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, starts[..., None] + torch.arange(length, device=x.device)]


def extract_windows(stream: torch.Tensor, trig: torch.Tensor, length: int) -> torch.Tensor:
    """Per-trigger sample windows [B, length] of a [N] stream.  Starts are
    clamped to [0, N - length], so callers pad the stream past the final
    frame."""
    t = torch.clamp(trig.long(), 0, stream.shape[-1] - length)
    return _rows(stream, t, length)


def extract_frames(stream: torch.Tensor, trig: torch.Tensor, period: int,
                   tol: int = 4) -> torch.Tensor:
    """Per-trigger frame windows [B, period], with the periodic fast path.

    When every trigger sits within ``tol`` samples of the affine model
    anchored at the MEDIAN per-frame offset, the windows are the
    contiguous run ``base + k*period`` (the anchor clipped to
    [0, N - B*period], as in the reference: that clip can move every
    window by more than ``tol``, a known reference quirk kept for
    parity); otherwise each window starts at its own trigger.
    """
    B = trig.shape[0]
    N = stream.shape[-1]
    if N < B * period:  # the uniform grid would not fit
        return extract_windows(stream, trig, period)
    k = torch.arange(B, device=trig.device)
    rel = trig.long() - k * period
    base = _median_trunc(rel)
    uniform = torch.all(torch.abs(rel - base) <= tol)
    fast = torch.clamp(base, 0, N - B * period) + k * period
    slow = torch.clamp(trig.long(), 0, N - period)
    return _rows(stream, torch.where(uniform, fast, slow), period)


def _periodic_starts(x_len: int, base: torch.Tensor, period: int, n: int,
                     length: int, left_pad: int) -> torch.Tensor:
    """Row starts of :func:`_periodic_rows` in the zero-padded array
    ``pad(x, (left_pad, period + length))``."""
    if length > period:
        raise ValueError(f"row length {length} exceeds the period {period}")
    xp_len = left_pad + x_len + period + length
    start = torch.clamp(base + left_pad, 0, xp_len - n * period)
    return start[..., None] + torch.arange(n, device=base.device) * period


def _periodic_rows(x: torch.Tensor, base: torch.Tensor, period: int, n: int,
                   length: int, left_pad: int) -> torch.Tensor:
    """Rows ``x[base + k*period : +length]`` for k < n.  ``x`` is
    zero-padded ``left_pad`` on the left, so a negative ``base`` reads
    zeros (it is not clipped), and ``period + length`` on the right.  A
    batch ``x`` [S, N] takes ``base`` [S] and gives [S, n, length]."""
    xp = F.pad(x, (left_pad, period + length))
    starts = _periodic_starts(x.shape[-1], base, period, n, length, left_pad)
    return (_rows if x.ndim == 1 else _rows_batch)(xp, starts, length)


def extract_frames_batch(streams: torch.Tensor, trig: torch.Tensor, period: int,
                         tol: int = 4, per_stream: bool = False) -> torch.Tensor:
    """:func:`extract_frames` over a batch of streams, with ONE uniformity
    vote for the whole batch: when every stream's triggers sit within
    ``tol`` of its own median anchor ``base_s + k*period``, every stream
    takes its periodic windows; otherwise every stream takes the exact
    per-trigger windows.  The vote is a ``torch.where`` on the start
    indices, followed by one gather: no host round trip.

    Args:
      streams: [S, N] per-stream sample rows.
      trig:    [S, B] per-stream window starts.
      per_stream: vote stream by stream instead (each stream as
               :func:`extract_frames` takes it alone).
    Returns [S, B, period].
    """
    S, N = streams.shape
    B = trig.shape[1]
    slow = torch.clamp(trig.long(), 0, N - period)
    if N < B * period:  # the uniform grid would not fit
        return _rows_batch(streams, slow, period)
    k = torch.arange(B, device=trig.device)
    rel = trig.long() - k * period
    base = _median_trunc(rel)  # [S]
    uniform = _vote(torch.abs(rel - base[:, None]) <= tol, per_stream)
    fast = torch.clamp(base, 0, N - B * period)[:, None] + k * period
    return _rows_batch(streams, torch.where(uniform, fast, slow), period)


def _vote(fits: torch.Tensor, per_stream: bool) -> torch.Tensor:
    """[S, B] fits of the affine model -> one decision for the batch, or
    [S, 1] decisions stream by stream."""
    return fits.all(dim=-1, keepdim=True) if per_stream else torch.all(fits)


def fine_cfo_batch(P: torch.Tensor, trig: torch.Tensor, cp_len: int, period: int,
                   tol: int = 4, per_stream: bool = False) -> torch.Tensor:
    """:func:`fine_cfo` (with ``period``) over a batch of streams, with ONE
    uniformity vote for the whole batch, as :func:`extract_frames_batch`
    (``per_stream``: a vote a stream).

    Args:
      P:    [S, N'] per-stream correlation rows.
      trig: [S, B] triggers.
    Returns [S, B] fractional CFO.
    """
    L = cp_len + 1
    B = trig.shape[1]
    n = P.shape[-1]
    t = trig.long()
    slow = torch.clamp(t - cp_len // 2, 0, n - L)
    k = torch.arange(B, device=t.device)
    rel = t - k * period
    base = _median_trunc(rel)  # [S]
    uniform = _vote(torch.abs(rel - base[:, None]) <= tol, per_stream)
    fast = _periodic_starts(n, base - cp_len // 2, period, B, L, left_pad=cp_len)
    Pp = F.pad(P, (cp_len, period + L))
    wins = _rows_batch(Pp, torch.where(uniform, fast, slow + cp_len), L)
    return (torch.angle(wins.sum(-1)) / math.pi).float()


def _moving_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """[..., N] -> [..., N - w + 1] windowed sums, numerically exact at any N.

    NOT a global-cumsum difference: on multi-Msample streams a float32
    running sum grows past the 24-bit mantissa and the difference of two
    big numbers corrupts the metric.  Two-level block sums instead:
    within each w-sized block an exclusive prefix, plus the block total,
    so every term sums at most 2w values whatever the stream length.
    """
    n = x.shape[-1]
    out_len = n - w + 1
    nb = -(-n // w)
    X = F.pad(x, (0, nb * w - n)).reshape(*x.shape[:-1], nb, w)
    pre = torch.cumsum(X, dim=-1)
    epre = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], dim=-1)
    tot = pre[..., -1:]
    epre_next = torch.cat([epre[..., 1:, :], torch.zeros_like(epre[..., :1, :])], dim=-2)
    # window starting at d = b*w + j: tail of block b from j, plus the
    # first j entries of block b+1
    ms = (tot - epre) + epre_next
    return ms.reshape(*x.shape[:-1], nb * w)[..., :out_len]


def timing_metric(r: torch.Tensor, fft_len: int = 64):
    """Schmidl-Cox P(d) and M(d) over a sample stream.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
    CUDA kernel (``ops/sync_cuda``), which raises for what it does not
    take (fft_len != 64, for one).

    Args:
      r: [N] or [S, N] complex64 stream(s).
    Returns (P, M): each [..., N - fft_len]; index d is the correlation
    window starting at sample d.
    """
    if r.device.type == "cpu":
        return _timing_metric_torch(r, fft_len)
    return sync_cuda.timing_metric_cuda(r, fft_len)


def _timing_metric_torch(r: torch.Tensor, fft_len: int = 64):
    """Plain PyTorch metric (any device); the formula is on :func:`timing_metric`."""
    half = fft_len // 2
    out = r.shape[-1] - fft_len
    lagged = torch.conj(r[..., :-half]) * r[..., half:]
    P = _moving_sum(lagged, half)[..., :out]
    # R1(d) = E(d), R2(d) = E(d+32): one moving sum serves both
    E = _moving_sum(torch.abs(r) ** 2, half)
    R1 = E[..., :out]
    R2 = E[..., half : half + out]
    M = torch.abs(P) ** 2 / torch.clamp(R1 * R2, min=1e-12)
    return P, M


def fold_detect(M: torch.Tensor, frame_samples: int, cp_len: int = 16) -> torch.Tensor:
    """Common trigger phase: fold the metric over the frame period (every
    frame votes) and locate the plateau by a circular cp-length boxcar.

    Args:
      M: [N'] timing metric.
    Returns 0-d int32 plateau-center offset in [0, frame_samples).
    """
    n_full = M.shape[-1] // frame_samples
    folded = M[..., : n_full * frame_samples].reshape(
        *M.shape[:-1], n_full, frame_samples).sum(-2)
    return phase_from_folded(folded, frame_samples, cp_len)


def phase_from_folded(folded: torch.Tensor, frame_samples: int,
                      cp_len: int = 16) -> torch.Tensor:
    """Circular plateau-center localization on a folded metric vote."""
    k = cp_len + 1
    ext = torch.cat([folded, folded[..., : k - 1]], dim=-1)
    win = _moving_sum(ext, k)  # [frame_samples] circular window sums
    # torch.argmax returns the first maximum, as jnp.argmax: on a tie
    # the earliest window wins in both packages
    start = torch.argmax(win, dim=-1)
    return ((start + k // 2) % frame_samples).int()


def frame_triggers(M: torch.Tensor, phase: torch.Tensor, frame_samples: int,
                   n_frames: int, search: int = 24) -> torch.Tensor:
    """Per-frame trigger refinement around the folded phase.

    For frame k, search M around phase + k*frame_samples and return the
    metric-weighted centroid of the plateau (samples above 80% of the
    local max), which sits mid-CP.  Positions outside the stream read
    zeros.  Returns [n_frames] int32 window-start indices; a batch M
    [S, N'] with phase [S] gives [S, n_frames].
    """
    L = 2 * search + 1
    base = phase.long() - search
    start = base[..., None] + torch.arange(n_frames, device=M.device) * frame_samples
    vals = _periodic_rows(M, base, frame_samples, n_frames, L, left_pad=search)
    local_max = vals.max(dim=-1, keepdim=True).values
    w = torch.where(vals > 0.8 * local_max, vals, 0.0)
    # centroid over RELATIVE offsets: absolute indices overflow float32's
    # 24-bit mantissa on multi-Msample streams
    rel = torch.arange(L, dtype=torch.float32, device=M.device)[None, :]
    centroid_rel = (w * rel).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)
    # torch.round rounds half to even, as jnp.round
    return (start + torch.round(centroid_rel).long()).int()


def fine_cfo(P: torch.Tensor, triggers: torch.Tensor, cp_len: int = 16,
             period: int | None = None) -> torch.Tensor:
    """Fractional CFO per frame, in subcarrier units: angle(P)/pi, with P
    averaged over the cp_len+1 plateau samples around each trigger.

    With ``period``, triggers that fit the affine model (as in
    :func:`extract_frames`) read their plateau windows at the median
    anchor ``base + k*period`` from a zero-left-padded P; otherwise each
    window starts at its own (clipped) trigger.
    """
    L = cp_len + 1
    B = triggers.shape[0]
    n = P.shape[-1]
    trig = triggers.long()
    slow = torch.clamp(trig - cp_len // 2, 0, n - L)
    if period is None:
        wins = _rows(P, slow, L)
    else:
        k = torch.arange(B, device=trig.device)
        rel = trig - k * period
        base = _median_trunc(rel)
        uniform = torch.all(torch.abs(rel - base) <= 4)
        fast = _periodic_starts(n, base - cp_len // 2, period, B, L, left_pad=cp_len)
        Pp = F.pad(P, (cp_len, period + L))
        wins = _rows(Pp, torch.where(uniform, fast, slow + cp_len), L)
    return (torch.angle(wins.sum(-1)) / math.pi).float()


def cfo_correct(frames: torch.Tensor, eps: torch.Tensor, fft_len: int = 64) -> torch.Tensor:
    """De-rotate per-frame sample windows [B, F] by the fractional CFO
    eps [B] (subcarrier units)."""
    n = torch.arange(frames.shape[-1], dtype=torch.float32, device=frames.device)
    ph = -2.0 * math.pi * eps[:, None] * n[None, :] / fft_len
    return frames * torch.exp(1j * ph)
