"""LDPC of the reference modem: the systematic encoder derived from an
alist H, and the log/sign-domain sum-product BP decoder as a loop over
iterations (one host read an iteration for the batch-wide exit), sums
over a node's slots taken left to right."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

SHORTENED_LLR = 15.0


def parse_alist(text: str) -> np.ndarray:
    """MacKay alist text -> dense H [M, N] uint8."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    n, m = (int(x) for x in lines[0].split())
    col_deg = [int(x) for x in lines[2].split()]
    H = np.zeros((m, n), np.uint8)
    for c in range(n):
        for tok in lines[4 + c].split():
            if int(tok) > 0:
                H[int(tok) - 1, c] = 1
    if len(col_deg) != n or any(H[:, c].sum() != d for c, d in enumerate(col_deg)):
        raise ValueError("malformed alist")
    return H


def _systematic(H: np.ndarray):
    """Column permutation and A with H[:, perm] = [A | I] (over GF(2))."""
    H = H.copy().astype(np.uint8)
    M, N = H.shape
    K = N - M
    perm = np.arange(N)
    for r in range(M):
        target = K + r
        pivot = None
        for cands in (range(target, N), range(0, target)):
            for c in cands:
                rows = np.nonzero(H[r:, perm[c]])[0]
                if rows.size:
                    pivot = r + rows[0]
                    perm[[target, c]] = perm[[c, target]]
                    break
            if pivot is not None:
                break
        if pivot is None:
            raise ValueError("H is rank deficient")
        if pivot != r:
            H[[r, pivot]] = H[[pivot, r]]
        for rr in np.nonzero(H[:, perm[target]])[0]:
            if rr != r:
                H[rr] ^= H[r]
    return perm, H[:, perm[:K]].copy()


@dataclasses.dataclass(frozen=True)
class Code:
    """A code in its transmitted column order [parity (M) | systematic (K)]."""

    M: int
    N: int
    K: int
    A: torch.Tensor  # [M, K] parity generator
    n_edge: int
    edge_var: torch.Tensor  # [E]
    edge_chk: torch.Tensor
    var_edges: torch.Tensor  # [N, dv], E = pad
    chk_edges: torch.Tensor  # [M, dc], E = pad
    chk_vars: torch.Tensor  # [M, dc], N = pad


def build_code(H: np.ndarray, device) -> Code:
    H = np.asarray(H, np.uint8)
    M, N = H.shape
    K = N - M
    perm, A = _systematic(H)
    Ht = H[:, np.concatenate([perm[K:], perm[:K]])]
    edge_chk, edge_var = np.nonzero(Ht)
    E = edge_chk.size
    var_edges = np.full((N, int(Ht.sum(0).max())), E, np.int64)
    chk_edges = np.full((M, int(Ht.sum(1).max())), E, np.int64)
    chk_vars = np.full(chk_edges.shape, N, np.int64)
    vf, cf = np.zeros(N, np.int64), np.zeros(M, np.int64)
    for e, (c, v) in enumerate(zip(edge_chk, edge_var)):
        var_edges[v, vf[v]] = e
        vf[v] += 1
        chk_edges[c, cf[c]] = e
        chk_vars[c, cf[c]] = v
        cf[c] += 1
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return Code(M=M, N=N, K=K, A=torch.as_tensor(A.astype(np.float32), device=device), n_edge=E,
                edge_var=t(edge_var), edge_chk=t(edge_chk), var_edges=t(var_edges),
                chk_edges=t(chk_edges), chk_vars=t(chk_vars))


def encode(msg: torch.Tensor, code: Code) -> torch.Tensor:
    """[B, K] bits -> [B, N] int32 codewords [parity | systematic]."""
    m = msg.float()
    return torch.cat([torch.remainder(m @ code.A.T, 2.0), m], dim=-1).int()


def _gather(x, idx, fill):
    return F.pad(x, (0, 1), value=fill)[:, idx.reshape(-1)].reshape(x.shape[0], *idx.shape)


def _slot_sum(x, idx):
    g = _gather(x, idx, 0.0)
    s = g[..., 0]
    for d in range(1, g.shape[-1]):
        s = s + g[..., d]
    return s


def _syndrome_ok(total, code: Code):
    return (_gather((total < 0).int(), code.chk_vars, 0).sum(-1) % 2 == 0).all(-1)


def decode(llr: torch.Tensor, code: Code, max_iters: int = 15):
    """(hard [B, N] int32, iters_used [B] int32, ok [B] bool).  A codeword
    stops at its first passing syndrome; its messages are then frozen."""
    B = llr.shape[0]
    c2v = torch.zeros((B, code.n_edge), dtype=torch.float32, device=llr.device)
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    done = torch.zeros(B, dtype=torch.bool, device=llr.device)
    for _ in range(max_iters):
        total = llr + _slot_sum(c2v, code.var_edges)
        done = done | _syndrome_ok(total, code)
        if bool(done.all()):
            break
        v2c = total[:, code.edge_var] - c2v
        t = torch.tanh(torch.clamp(v2c, -20.0, 20.0) / 2.0)
        mag = torch.log(torch.clamp(t.abs(), min=1e-12))
        neg = (t < 0).float()
        loo_mag = _slot_sum(mag, code.chk_edges)[:, code.edge_chk] - mag
        loo_neg = _gather(neg, code.chk_edges, 0.0).sum(-1)[:, code.edge_chk] - neg
        sign = 1.0 - 2.0 * torch.remainder(loo_neg, 2.0)
        loo = torch.clamp(sign * torch.exp(loo_mag), -0.999999, 0.999999)
        c2v = torch.where(done[:, None], c2v, 2.0 * torch.atanh(loo))
        iters = iters + (~done).int()
    total = llr + _slot_sum(c2v, code.var_edges)
    return (total < 0).int(), iters, done | _syndrome_ok(total, code)
