"""What the LDPC benches share: the n=300/k=152 demo code, seeded
codewords, LLRs of a regime, and a decoder's ok rate and mean iterations
on one batch."""

from __future__ import annotations

import numpy as np
import torch

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.tools.bench_fec import ROOT
from gr_dtl_tpu_torch.utils import alist

__all__ = ["N300", "n300", "codewords", "regime_llrs", "ok_and_iters"]

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
