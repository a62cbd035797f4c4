"""What the LDPC benches share: the n=300/k=152 demo code, seeded
codewords, LLRs of a regime, a decoder's ok rate and mean iterations on
one batch, and regular quasi-cyclic parity checks of any row degree."""

from __future__ import annotations

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.tools.bench_fec import ROOT
from gr_dtl_tpu_torch.utils import alist

__all__ = ["N300", "n300", "codewords", "regime_llrs", "ok_and_iters", "qc_parity", "zero_word_llrs"]

N300 = ROOT / "examples" / "n_0300_k_0152.alist"


def n300():
    """The demo code's parity-check matrix."""
    return alist.load_alist(str(N300))


def codewords(code: ldpc.LdpcCode, n: int, rng: np.random.RandomState) -> torch.Tensor:
    """[n, N] float32 codewords of messages drawn from ``rng``, on the
    code's device."""
    msg = rng.randint(0, 2, size=(n, code.K)).astype(np.float32)
    return ldpc.encode(torch.as_tensor(msg, device=code.A.device), code).float()


def regime_llrs(cws: torch.Tensor, amp: float, sigma: float, seed: int) -> torch.Tensor:
    """``(1 - 2 c) * amp + sigma * n``, n standard normal from a
    ``torch.Generator`` seeded ``seed`` on the codewords' device."""
    gen = torch.Generator(device=cws.device).manual_seed(seed)
    return (1.0 - 2.0 * cws) * amp + torch.randn(cws.shape, generator=gen, device=cws.device) * sigma


def ok_and_iters(out) -> dict:
    """``{"ok_rate", "avg_iters"}`` of a decoder's (hard, iters, ok)."""
    _, it, ok = out
    return {"ok_rate": float(ok.float().mean()), "avg_iters": float(it.float().mean())}


def qc_parity(dv: int, dc: int, z: int, seed: int = 0) -> np.ndarray:
    """A regular quasi-cyclic parity-check matrix, [dv z, dc z] uint8: block
    (i, j) the z x z identity rolled by a shift from RandomState(seed), so
    every check holds dc variables and every variable sits in dv checks.
    The shipped codes' rows hold at most 7 variables; these reach K3's
    rows of any degree (above 8 its guarded instantiation)."""
    shifts = np.random.RandomState(seed).randint(0, z, (dv, dc))
    eye = np.eye(z, dtype=np.uint8)
    return np.block([[np.roll(eye, int(k), axis=1) for k in row] for row in shifts])


def zero_word_llrs(n: int, N: int, seed: int, regimes=((4.0, 1.2), (4.0, 1.6), (4.0, 2.2))) -> np.ndarray:
    """[n, N] float32 LLRs of the all-zero word (a codeword of every code):
    ``amp + sigma * noise`` from RandomState(seed), the rows split evenly
    among the (amp, sigma) regimes, so that some converge at once, some
    after updates and some never."""
    rng = np.random.RandomState(seed)
    amp, sigma = (np.repeat(np.asarray(regimes, np.float64)[:, k], -(-n // len(regimes)))[:n, None] for k in (0, 1))
    return (amp + sigma * rng.randn(n, N)).astype(np.float32)
