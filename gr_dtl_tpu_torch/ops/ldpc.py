"""LDPC encode and batched sum-product BP decode (port of gr_dtl_tpu/ops/ldpc.py).

Host part (numpy, bit-equal to the reference's dicts): a systematic
generator derived from the alist H by Gaussian elimination with column
pivoting (:func:`build_ldpc`), and a code bank padded to one layout
(:func:`build_ldpc_bank`).  :func:`ldpc_from_reference` and
:func:`bank_from_reference` turn those dicts into frozen dataclasses of
device tensors.

Device part:

- :func:`encode` / :func:`encode_bank`: parity = msg @ A^T mod 2, a
  float32 matmul of 0/1 values (exact integers with TF32 off);
- :func:`decode_mm` / :func:`decode_bank_mm`: the reference's log/sign
  domain sum-product BP on a flat ``[B, E]`` edge-message tensor.  The
  reference multiplies by dense 0/1 incidence matrices (its MXU form);
  here every such product is a gather over padded Tanner-graph index
  tables plus a sum over the (3- or 7-wide) degree axis: the same sums
  in another order, without the ~99.7% of matmul FLOPs that multiply
  zeros.  Sign and syndrome counts stay exact integers.
  ``GR_DTL_TPU_BP_BF16=1`` (read at every call; ``decode_mm``'s ``bf16``
  keyword overrides it) rounds to bfloat16 exactly the operands the reference
  feeds its incidence matmuls in bfloat16, and sums in float32;
- :func:`decode_mm_twopass`: the straggler schedule, a short full-batch
  pass, then converged-last buckets decoded afresh with the full budget;
- :func:`decode` / :func:`decode_bank`: the reference's gather form
  (tanh-product check update on ``[B, M, R]`` messages), for one code or
  with per-codeword code selection (large banks).

Early exit: the reference scans a fixed 15 iterations and skips the
message update once every codeword's syndrome passed; ``iters_used``
counts per codeword and a converged codeword's messages are frozen, so the
update it would still take changes nothing it returns.  On a CUDA tensor
``decode_mm`` and ``decode_bank_mm`` run K3, ``ops/ldpc_cuda.bp_decode_cuda``
(``csrc/ldpc_bp.cu``), in one launch a call (a bank's too, every row with
its own code): a block a codeword, each stopping at its own syndrome pass,
with no host check; a failed build or launch raises.  On a CPU tensor they run the plain version ``_bp``,
whose loop breaks once every row has converged (one host read an
iteration; ``early_exit=False`` runs every iteration).  ``(hard,
iters_used, ok)`` are the same either way.  ``decode`` and ``decode_bank``
do the same with K8, ``ops/ldpc_cuda.bp_gather_cuda`` (K3's frame and
tables with the gather form's tanh-product update), on a CUDA tensor, and
with their plain version ``_bp_gather`` on a CPU one.

Codeword layout ``[check bits | systematic bits]``; LLR > 0 <=> bit 0;
shortened bits are pinned at ``+SHORTENED_LLR``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from gr_dtl_tpu_torch.ops import ldpc_cuda

__all__ = ["SHORTENED_LLR", "build_ldpc", "build_ldpc_bank", "BpGraph", "LdpcCode",
           "LdpcBank", "ldpc_from_reference", "bank_from_reference", "encode", "encode_bank",
           "decode", "decode_mm", "decode_mm_twopass", "decode_bank_mm", "decode_bank"]

SHORTENED_LLR = 15.0


# ---------------------------------------------------------------------------
# host constants (numpy)
# ---------------------------------------------------------------------------

def _gf2_solve_systematic(H: np.ndarray):
    """Column-permute H and reduce so H_perm = [A | I_M] (systematic form).

    Returns (col_perm [N], A [M, K]) with K = N - M, such that for the
    permuted codeword c = [s | p]: p = A @ s (mod 2).
    """
    H = H.copy().astype(np.uint8)
    M, N = H.shape
    K = N - M
    perm = np.arange(N)
    # pivot for row r targets permuted column K + r
    for r in range(M):
        target = K + r
        pivot_row = None
        for c_idx in range(target, N):
            rows = np.nonzero(H[r:, perm[c_idx]])[0]
            if rows.size:
                pivot_row = r + rows[0]
                perm[[target, c_idx]] = perm[[c_idx, target]]
                break
        if pivot_row is None:
            for c_idx in range(0, target):
                rows = np.nonzero(H[r:, perm[c_idx]])[0]
                if rows.size:
                    pivot_row = r + rows[0]
                    perm[[target, c_idx]] = perm[[c_idx, target]]
                    break
        if pivot_row is None:
            raise ValueError("H is rank deficient")
        if pivot_row != r:
            H[[r, pivot_row]] = H[[pivot_row, r]]
        col = perm[target]
        for rr in np.nonzero(H[:, col])[0]:
            if rr != r:
                H[rr] ^= H[r]
    A = H[:, perm[:K]].copy()
    return perm, A


def build_ldpc(H: np.ndarray) -> dict:
    """Encoder/decoder constants from a parity-check matrix, as numpy: the
    reference's dict, key for key.  Transmitted layout: cw = [parity (M) |
    systematic (K)] in the original H column order of the derived
    permutation."""
    H = np.asarray(H, dtype=np.uint8)
    M, N = H.shape
    K = N - M
    perm, A = _gf2_solve_systematic(H)
    tx_cols = np.concatenate([perm[K:], perm[:K]])  # [parity | systematic]
    Ht = H[:, tx_cols]

    max_row = int(Ht.sum(axis=1).max())
    max_col = int(Ht.sum(axis=0).max())
    chk_adj = np.full((M, max_row), -1, dtype=np.int32)
    for r in range(M):
        cols = np.nonzero(Ht[r])[0]
        chk_adj[r, : cols.size] = cols
    var_edges = np.full((N, max_col, 2), -1, dtype=np.int32)
    var_deg = np.zeros(N, dtype=np.int32)
    for r in range(M):
        for s, c in enumerate(chk_adj[r]):
            if c >= 0:
                var_edges[c, var_deg[c]] = (r, s)
                var_deg[c] += 1

    edge_chk, edge_var = np.nonzero(Ht)
    E = edge_chk.size
    Vmat = np.zeros((N, E), np.float32)
    Cmat = np.zeros((M, E), np.float32)
    Vmat[edge_var, np.arange(E)] = 1.0
    Cmat[edge_chk, np.arange(E)] = 1.0
    return {
        "M": M, "N": N, "K": K,
        "A": A.astype(np.float32),
        "chk_adj": chk_adj,
        "chk_mask": (chk_adj >= 0),
        "var_edges": var_edges,
        "var_mask": (var_edges[..., 0] >= 0),
        "Ht": Ht,
        "E": E, "Vmat": Vmat, "Cmat": Cmat,
    }


def _reverse_map(var_edges: np.ndarray, M: int, R: int) -> np.ndarray:
    """[M, R, 2]: for each (check, slot) edge its (variable, variable slot)."""
    rev = np.zeros((M, R, 2), np.int64)
    for v in range(var_edges.shape[0]):
        for s in range(var_edges.shape[1]):
            m, r = var_edges[v, s]
            if m >= 0:
                rev[m, r] = (v, s)
    return rev


def build_ldpc_bank(Hs: list) -> dict:
    """Several codes in padded tables, as numpy: the reference's dict.

    All codes share the layout ``[parity: Mmax | systematic: Kmax]``; code
    c's real slots are ``parity[:M_c]`` and ``sys[:K_c]``.  Code ids are
    1-based; row 0 of every table is a copy of code 1.
    """
    codes = [build_ldpc(H) for H in Hs]
    C = len(codes)
    Mmax = max(c["M"] for c in codes)
    Kmax = max(c["K"] for c in codes)
    Nmax = Mmax + Kmax
    Rmax = max(c["chk_adj"].shape[1] for c in codes)
    Dmax = max(c["var_edges"].shape[1] for c in codes)

    chk_adj = np.full((C + 1, Mmax, Rmax), -1, np.int32)
    var_edges = np.full((C + 1, Nmax, Dmax, 2), -1, np.int32)
    rev = np.zeros((C + 1, Mmax, Rmax, 2), np.int32)
    A = np.zeros((C + 1, Mmax, Kmax), np.float32)
    n_tab = np.zeros(C + 1, np.int32)
    k_tab = np.zeros(C + 1, np.int32)
    m_tab = np.zeros(C + 1, np.int32)

    for ci, code in enumerate(codes, start=1):
        M, K = code["M"], code["K"]

        def remap(idx, M=M):
            return np.where(idx < M, idx, Mmax + (idx - M))

        ca = code["chk_adj"]
        chk_adj[ci, :M, : ca.shape[1]] = np.where(ca >= 0, remap(ca), -1)
        ve = code["var_edges"]
        var_edges[ci, remap(np.arange(code["N"])), : ve.shape[1]] = ve
        rc = _reverse_map(ve, M, Rmax)
        rev[ci, :M] = np.stack([remap(rc[..., 0]), rc[..., 1]], -1)
        A[ci, :M, :K] = code["A"]
        n_tab[ci], k_tab[ci], m_tab[ci] = code["N"], code["K"], code["M"]

    chk_adj[0], var_edges[0], rev[0], A[0] = chk_adj[1], var_edges[1], rev[1], A[1]
    n_tab[0], k_tab[0], m_tab[0] = n_tab[1], k_tab[1], m_tab[1]

    # per-code incidence in the padded coordinates (decode_bank_mm)
    mm = [None]
    for code in codes:
        M = code["M"]
        Ht_pad = np.zeros((Mmax, Nmax), np.uint8)
        j = np.arange(code["N"])
        Ht_pad[:M, np.where(j < M, j, Mmax + (j - M))] = code["Ht"]
        e_chk, e_var = np.nonzero(Ht_pad)
        E = e_chk.size
        Vm = np.zeros((Nmax, E), np.float32)
        Cm = np.zeros((Mmax, E), np.float32)
        Vm[e_var, np.arange(E)] = 1.0
        Cm[e_chk, np.arange(E)] = 1.0
        mm.append({"Vmat": Vm, "Cmat": Cm, "Ht": Ht_pad, "E": E})

    return {
        "n_codes": C, "Mmax": Mmax, "Kmax": Kmax, "Nmax": Nmax,
        "chk_adj": chk_adj, "chk_mask": chk_adj >= 0,
        "var_edges": var_edges, "var_mask": var_edges[..., 0] >= 0,
        "rev": rev, "A": A,
        "n_tab": n_tab, "k_tab": k_tab, "m_tab": m_tab,
        "codes": codes, "mm": mm,
    }


# ---------------------------------------------------------------------------
# device constants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BpGraph:
    """Tanner-graph index tables of one code for the gather-form BP.  Edge
    e joins check ``edge_chk[e]`` and variable ``edge_var[e]``, in the
    reference's edge order (``np.nonzero(Ht)``).  Padded slots of
    ``var_edges``/``chk_edges`` hold E and of ``chk_vars`` hold N: they
    read an appended zero."""

    n_var: int
    n_chk: int
    n_edge: int
    edge_var: torch.Tensor  # [E] int64
    edge_chk: torch.Tensor  # [E] int64
    var_edges: torch.Tensor  # [N, max_col_deg] int64
    chk_edges: torch.Tensor  # [M, max_row_deg] int64
    chk_vars: torch.Tensor  # [M, max_row_deg] int64


def _graph(Ht: np.ndarray, device) -> BpGraph:
    Ht = np.asarray(Ht)
    M, N = Ht.shape
    edge_chk, edge_var = np.nonzero(Ht)
    E = edge_chk.size
    var_edges = np.full((N, max(int(Ht.sum(0).max()), 1)), E, np.int64)
    chk_edges = np.full((M, max(int(Ht.sum(1).max()), 1)), E, np.int64)
    chk_vars = np.full(chk_edges.shape, N, np.int64)
    vfill = np.zeros(N, np.int64)
    cfill = np.zeros(M, np.int64)
    for e, (c, v) in enumerate(zip(edge_chk, edge_var)):
        var_edges[v, vfill[v]] = e
        vfill[v] += 1
        chk_edges[c, cfill[c]] = e
        chk_vars[c, cfill[c]] = v
        cfill[c] += 1
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return BpGraph(n_var=N, n_chk=M, n_edge=E, edge_var=t(edge_var), edge_chk=t(edge_chk),
                   var_edges=t(var_edges), chk_edges=t(chk_edges), chk_vars=t(chk_vars))


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """One code on the device (the reference's ``build_ldpc`` dict)."""

    M: int
    N: int
    K: int
    A: torch.Tensor  # [M, K] float32 parity generator
    graph: BpGraph
    # gather-form tables (decode), as a one-code bank holds them
    chk_adj: torch.Tensor  # [M, R] int64, -1 = pad
    var_edges: torch.Tensor  # [N, D, 2] int64, -1 = pad
    rev: torch.Tensor  # [M, R, 2] int64


@dataclasses.dataclass(frozen=True)
class LdpcBank:
    """A code bank on the device (the reference's ``build_ldpc_bank`` dict).
    Tables are indexed by 1-based code id; row 0 is code 1."""

    n_codes: int
    Mmax: int
    Kmax: int
    Nmax: int
    A: torch.Tensor  # [C+1, Mmax, Kmax] float32
    n_tab: torch.Tensor  # [C+1] int32
    k_tab: torch.Tensor
    m_tab: torch.Tensor
    codes: tuple  # LdpcCode per code, own layout
    graphs: tuple  # BpGraph per code, padded layout (decode_bank_mm)
    # gather-form tables per code id (decode_bank)
    chk_adj: torch.Tensor  # [C+1, Mmax, R] int64, -1 = pad
    var_edges: torch.Tensor  # [C+1, Nmax, D, 2] int64, -1 = pad
    rev: torch.Tensor  # [C+1, Mmax, R, 2] int64


def ldpc_from_reference(d, device) -> LdpcCode:
    """:class:`LdpcCode` on ``device`` from a ``build_ldpc`` dict (numpy leaves)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    chk_adj, var_edges = np.asarray(d["chk_adj"]), np.asarray(d["var_edges"])
    return LdpcCode(M=int(d["M"]), N=int(d["N"]), K=int(d["K"]),
                    A=torch.as_tensor(np.asarray(d["A"], np.float32), device=device),
                    graph=_graph(d["Ht"], device), chk_adj=t(chk_adj), var_edges=t(var_edges),
                    rev=t(_reverse_map(var_edges, *chk_adj.shape)))


def bank_from_reference(d, device) -> LdpcBank:
    """:class:`LdpcBank` on ``device`` from a ``build_ldpc_bank`` dict."""
    C = int(d["n_codes"])
    t = lambda a, dt: torch.as_tensor(np.asarray(a).astype(dt), device=device)
    return LdpcBank(
        n_codes=C, Mmax=int(d["Mmax"]), Kmax=int(d["Kmax"]), Nmax=int(d["Nmax"]),
        A=t(d["A"], np.float32), n_tab=t(d["n_tab"], np.int32), k_tab=t(d["k_tab"], np.int32),
        m_tab=t(d["m_tab"], np.int32),
        codes=tuple(ldpc_from_reference(c, device) for c in d["codes"]),
        graphs=tuple(_graph(d["mm"][ci]["Ht"], device) for ci in range(1, C + 1)),
        chk_adj=t(d["chk_adj"], np.int64), var_edges=t(d["var_edges"], np.int64),
        rev=t(d["rev"], np.int64))


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def encode(msg_bits: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """[B, K] bits -> [B, N] int32 codewords [parity | systematic]."""
    m = msg_bits.float()
    parity = torch.remainder(m @ code.A.T, 2.0)
    return torch.cat([parity, m], dim=-1).int()


def encode_bank(msg_bits: torch.Tensor, code_idx: torch.Tensor, bank: LdpcBank) -> torch.Tensor:
    """[B, Kmax] bits + [B] 1-based code ids -> [B, Nmax] int32 padded
    codewords ``[parity: Mmax | systematic: Kmax]`` (bits beyond each
    code's K must be zero).  One matmul per table row, selected per
    codeword: the reference's per-codeword ``[B, Mmax, Kmax]`` gather of
    the generator, without materialising it."""
    m = msg_bits.float()
    parity = torch.zeros((m.shape[0], bank.Mmax), dtype=torch.float32, device=m.device)
    for c in range(bank.n_codes + 1):
        parity = torch.where((code_idx == c)[:, None], m @ bank.A[c].T, parity)
    return torch.cat([parity.int() % 2, msg_bits.int()], dim=-1)


# ---------------------------------------------------------------------------
# BP decoders
# ---------------------------------------------------------------------------

def _bf16_switch(bf16: bool | None) -> bool:
    """The ``GR_DTL_TPU_BP_BF16`` switch, read now, unless ``bf16`` says."""
    return os.environ.get("GR_DTL_TPU_BP_BF16", "0") == "1" if bf16 is None else bool(bf16)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest bfloat16 (ties to even) -> float32."""
    return x.to(torch.bfloat16).float()


def _gather(x: torch.Tensor, idx: torch.Tensor, fill: float) -> torch.Tensor:
    """x [B, L] -> [B, *idx.shape]; an index of L reads ``fill``."""
    xp = F.pad(x, (0, 1), value=fill)
    return xp[:, idx.reshape(-1)].reshape(x.shape[0], *idx.shape)


def _fold(x: torch.Tensor, op) -> torch.Tensor:
    """``op`` over x's last axis, left to right from slot 0:
    ``op(op(x[..., 0], x[..., 1]), x[..., 2]) ...``, one rounding a slot.
    A reduction kernel combines in an order of its own, another on the CPU
    than on the card; this order is the one K3 and K8 (``csrc/ldpc_bp.cu``)
    take."""
    s = x[..., 0]
    for d in range(1, x.shape[-1]):
        s = op(s, x[..., d])
    return s


def _slot_sum(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, L] gathered at idx [R, D] (an index of L reads 0) and summed
    over the D slots left to right: ``((x[i0] + x[i1]) + x[i2]) + ...``."""
    return _fold(_gather(x, idx, 0.0), torch.add)


def _slot_prod(t: torch.Tensor) -> torch.Tensor:
    """t's product over its last axis, left to right from slot 0:
    ``((t0 * t1) * t2) * ...``, the order K8 multiplies a check's slots in."""
    return _fold(t, torch.mul)


def _syndrome_ok(total: torch.Tensor, g: BpGraph) -> torch.Tensor:
    """[B] bool: every parity check of the hard decision is satisfied
    (integer counts, exact)."""
    hard = (total < 0).to(torch.int32)
    return (_gather(hard, g.chk_vars, 0).sum(-1) % 2 == 0).all(-1)


def _var_totals(llr: torch.Tensor, c2v: torch.Tensor, g: BpGraph, bf16: bool) -> torch.Tensor:
    """Channel LLR plus every incoming check message, per variable."""
    return llr + _slot_sum(_round_bf16(c2v) if bf16 else c2v, g.var_edges)


def _check_update(c2v, total, done, g: BpGraph, bf16: bool):
    """One log/sign-domain check-node update (the reference's ``msg_update``
    in ``decode_mm``); converged codewords keep their messages.  With
    ``bf16`` the operands of the reference's bfloat16 matmuls (``total``,
    ``mag``, ``sum_mag``) are rounded to bfloat16 before they are summed;
    the subtrahends stay float32, as there."""
    rnd = _round_bf16 if bf16 else (lambda x: x)
    v2c = rnd(total)[:, g.edge_var] - c2v  # leave-one-out at variables
    t = torch.tanh(torch.clamp(v2c, -20.0, 20.0) / 2.0)
    mag = torch.log(torch.clamp(t.abs(), min=1e-12))
    neg = (t < 0).float()
    sum_mag = _slot_sum(rnd(mag), g.chk_edges)  # [B, M]
    sum_neg = _gather(neg, g.chk_edges, 0.0).sum(-1)
    loo_mag = rnd(sum_mag)[:, g.edge_chk] - mag  # leave-one-out at checks
    loo_neg = sum_neg[:, g.edge_chk] - neg
    sign = 1.0 - 2.0 * torch.remainder(loo_neg, 2.0)
    loo = torch.clamp(sign * torch.exp(loo_mag), -0.999999, 0.999999)
    return torch.where(done[:, None], c2v, 2.0 * torch.atanh(loo))


def _bp(llr: torch.Tensor, g: BpGraph, max_iters: int = 15,
        done: torch.Tensor | None = None, early_exit: bool = True, bf16: bool = False):
    """Sum-product BP over one graph -> (hard [B, N] int32, iters_used [B]
    int32, ok [B] bool, final total LLRs [B, N]).  ``done`` marks rows to
    treat as converged from the start (their messages stay 0)."""
    B = llr.shape[0]
    c2v = torch.zeros((B, g.n_edge), dtype=torch.float32, device=llr.device)
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    if done is None:
        done = torch.zeros(B, dtype=torch.bool, device=llr.device)
    for _ in range(max_iters):
        total = _var_totals(llr, c2v, g, bf16)
        done = done | _syndrome_ok(total, g)
        # batch-wide exit: once every syndrome passed the update is frozen
        # everywhere, so skip it from this iteration on (one host sync)
        if early_exit and bool(done.all()):
            break
        c2v = _check_update(c2v, total, done, g, bf16)
        iters = iters + (~done).int()
    total = _var_totals(llr, c2v, g, bf16)
    return (total < 0).int(), iters, done | _syndrome_ok(total, g), total


def _decode(llr: torch.Tensor, g: BpGraph, max_iters: int, done: torch.Tensor | None, bf16: bool):
    """(hard, iters_used, ok) of one graph: K3 on a CUDA tensor, ``_bp`` on a CPU one."""
    if llr.is_cuda:
        return ldpc_cuda.bp_decode_cuda(llr.contiguous(), g, max_iters, done=done, bf16=bf16)
    return _bp(llr, g, max_iters, done=done, bf16=bf16)[:3]


def decode_mm(llr: torch.Tensor, code: LdpcCode, max_iters: int = 15, bf16: bool | None = None):
    """Batched sum-product BP, the reference's ``decode_mm`` contract.

    Args:
      llr: [B, N] float32 in transmitted order, LLR > 0 <=> bit 0.
      bf16: round the summed operands to bfloat16 (the reference's
        bfloat16 matmul inputs); None reads ``GR_DTL_TPU_BP_BF16``.
    Returns (hard [B, N] int32, iters_used [B] int32, ok [B] bool);
    ``iters_used`` counts the message updates a codeword took part in
    (max_iters if its syndrome never passed).
    """
    return _decode(llr.float(), code.graph, max_iters, None, _bf16_switch(bf16))


def decode_mm_twopass(llr: torch.Tensor, code: LdpcCode, max_iters: int = 15, first: int = 3,
                      bucket: int | None = None):
    """Straggler-scheduled BP (the reference's ``decode_mm_twopass``).

    1. :func:`decode_mm` with ``first`` iterations over the whole batch;
    2. rows ordered converged-last (a stable sort on pass 1's ``ok``),
       padded with all-zero LLR rows (the all-zeros codeword, converged at
       entry) to whole ``bucket``-row groups, ``bucket`` by default
       ``max(128, B // 8)``;
    3. each group decoded afresh with ``max_iters``, so only groups that
       hold stragglers run message updates, on ``bucket`` rows.

    A row that passed in pass 1 keeps pass 1's results; any other reports
    pass 1's iterations plus pass 2's, and pass 2's hard bits and ``ok``.
    A row's BP does not depend on the other rows of its batch, so the
    grouping changes no result.  Same ``(hard, iters_used, ok)`` contract
    as :func:`decode_mm`.
    """
    llr = llr.float()
    B, N = llr.shape
    bf16 = _bf16_switch(None)
    if bucket is None:
        bucket = max(128, B // 8)
    nb = -(-B // bucket)
    pad = nb * bucket - B
    hard1, it1, done1 = decode_mm(llr, code, first, bf16)
    order = torch.argsort(done1.int(), stable=True)
    if pad:
        llr = torch.cat([llr, llr.new_zeros((pad, N))])
        order = torch.cat([order, torch.arange(B, B + pad, device=order.device)])
    llr_s = llr[order]
    groups = [decode_mm(llr_s[i * bucket:(i + 1) * bucket], code, max_iters, bf16)
              for i in range(nb)]
    inv = torch.argsort(order)[:B]
    hard2, it2, ok2 = (torch.cat(col)[inv] for col in zip(*groups))
    hard = torch.where(done1[:, None], hard1, hard2)
    iters = torch.where(done1, it1, it1 + it2)
    return hard, iters, done1 | ok2


def decode_bank_mm(llr: torch.Tensor, code_idx: torch.Tensor, bank: LdpcBank,
                   max_iters: int = 15):
    """BP over a small code bank, each codeword with its own code's graph
    (the reference's ``decode_bank_mm`` contract, which runs every code's
    ``decode_mm`` over the whole batch, keeps each codeword's own code's
    result, and so honours ``GR_DTL_TPU_BP_BF16`` too).  A row's result does
    not depend on the other rows, so on a CUDA tensor one K3 launch decodes
    every row with its own code.  On a CPU tensor ``_bp`` runs once a code
    with the other codes' rows marked converged (they take no update and
    never hold back its batch-wide exit), and the results are merged."""
    llr = llr.float()
    bf16 = _bf16_switch(None)
    if llr.is_cuda:
        idx = code_idx if code_idx.dtype in (torch.int32, torch.int64) else code_idx.long()
        return ldpc_cuda.bp_decode_cuda(llr.contiguous(), bank.graphs, max_iters, bf16=bf16,
                                        code_idx=idx.contiguous())
    sel = torch.clamp(code_idx, 1, bank.n_codes) - 1
    B, N = llr.shape
    hard = torch.zeros((B, N), dtype=torch.int32, device=llr.device)
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    ok = torch.zeros(B, dtype=torch.bool, device=llr.device)
    for ci, g in enumerate(bank.graphs):
        mine = sel == ci
        h, it, o = _decode(llr, g, max_iters, ~mine, bf16)
        hard = torch.where(mine[:, None], h, hard)
        iters = torch.where(mine, it, iters)
        ok = torch.where(mine, o, ok)
    return hard, iters, ok


def _bp_gather(llr: torch.Tensor, chk_adj: torch.Tensor, var_edges: torch.Tensor,
               rev: torch.Tensor, max_iters: int):
    """The reference's gather-form BP (tanh-product check update on
    ``[B, M, R]`` messages), K8's plain version.  The tables are one code's
    (``chk_adj`` [M, R], ``var_edges`` [N, D, 2], ``rev`` [M, R, 2]) or one
    per codeword (a leading [B] axis): the indexing broadcasts either.  A
    variable's slots add and a check's slots multiply left to right from
    slot 0 (``_fold``), the order K8 takes.  On a CPU tensor the loop
    breaks once every row has converged (one host read an iteration)."""
    llr = llr.float()
    B = llr.shape[0]
    dev = llr.device
    chk_mask = chk_adj >= 0
    var_mask = var_edges[..., 0] >= 0
    M, R = chk_adj.shape[-2:]
    safe_adj = torch.clamp(chk_adj, min=0)
    ve_chk = torch.clamp(var_edges[..., 0], min=0)
    ve_slot = torch.clamp(var_edges[..., 1], min=0)
    rev_var, rev_slot = rev[..., 0], rev[..., 1]
    b_ix = torch.arange(B, device=dev)[:, None, None]

    def check_update(v2c):
        t = torch.tanh(torch.clamp(v2c, -20.0, 20.0) / 2.0)
        t = torch.where(chk_mask, t, 1.0)
        prod = _slot_prod(t)[..., None]
        # leave-one-out product; guard tiny values for the division
        t_safe = torch.where(t.abs() < 1e-12, torch.sign(t) * 1e-12 + 1e-30, t)
        loo = torch.clamp(prod / t_safe, -0.999999, 0.999999)
        return 2.0 * torch.atanh(loo)

    def syndrome_ok(total):
        hard = (total < 0).to(torch.int32)
        bits = torch.where(chk_mask, hard[b_ix, safe_adj], 0)
        return (bits.sum(-1) % 2 == 0).all(-1)

    def totals(c2v):
        inc = torch.where(var_mask, c2v[b_ix, ve_chk, ve_slot], 0.0)  # [B, N, D]
        return inc, llr + _fold(inc, torch.add)

    c2v = torch.zeros((B, M, R), dtype=torch.float32, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        inc, total = totals(c2v)
        done = done | syndrome_ok(total)
        if bool(done.all()):  # batch-wide exit, as in decode_mm
            break
        v2c = (total[:, :, None] - inc)[b_ix, rev_var, rev_slot]  # [B, M, R]
        c2v = torch.where(done[:, None, None], c2v, check_update(v2c))
        iters = iters + (~done).int()
    _, total = totals(c2v)
    return (total < 0).int(), iters, done | syndrome_ok(total)


def _bank_rows(code_idx: torch.Tensor, n_codes: int) -> torch.Tensor:
    """The table row of each code id, as the reference's jnp indexing of
    the ``n_codes + 1`` rows takes it: a negative id counts from the end
    once, then the row clamps to ``[0, n_codes]`` (row 0 is code 1).  On
    the ids' device, with no host read."""
    idx = code_idx.long()
    return torch.clamp(torch.where(idx < 0, idx + (n_codes + 1), idx), 0, n_codes)


def _gather_tables(src, code_idx: torch.Tensor | None) -> tuple:
    """The gather form's tables (``chk_adj``, ``var_edges``, ``rev``): a
    code's own, or each codeword's row of a bank's by :func:`_bank_rows`."""
    if code_idx is None:
        return src.chk_adj, src.var_edges, src.rev
    row = _bank_rows(code_idx, src.n_codes)
    return src.chk_adj[row], src.var_edges[row], src.rev[row]


def _decode_gather(llr: torch.Tensor, src, max_iters: int, code_idx: torch.Tensor | None = None):
    """(hard, iters_used, ok) of the gather form over a code (``src`` an
    :class:`LdpcCode`) or a bank with a code id a row: K8 on a CUDA tensor,
    ``_bp_gather`` on a CPU one."""
    if llr.is_cuda:
        graph = src.graph if code_idx is None else src.graphs
        if code_idx is not None and code_idx.dtype not in (torch.int32, torch.int64):
            code_idx = code_idx.long()
        return ldpc_cuda.bp_gather_cuda(llr.contiguous(), graph, max_iters,
                                        code_idx=None if code_idx is None else code_idx.contiguous())
    return _bp_gather(llr, *_gather_tables(src, code_idx), max_iters)


def decode(llr: torch.Tensor, code: LdpcCode, max_iters: int = 15):
    """Batched sum-product BP of one code in the reference's gather form.

    Args:
      llr: [B, N] float32 in transmitted order, LLR > 0 <=> bit 0.
    Returns (hard [B, N] int32, iters_used [B] int32, ok [B] bool), as
    :func:`decode_mm`.
    """
    return _decode_gather(llr.float(), code, max_iters)


def decode_bank(llr: torch.Tensor, code_idx: torch.Tensor, bank: LdpcBank,
                max_iters: int = 15):
    """Batched sum-product BP with per-codeword code selection, the
    reference's gather form.

    Args:
      llr: [B, Nmax] float32 in the padded layout (unused slots pinned to
           +SHORTENED_LLR); LLR > 0 <=> bit 0.
      code_idx: [B] 1-based code ids, taken as the reference indexes its
           tables by them (:func:`_bank_rows`: a negative id counts from
           the end once, then clamps; row 0 is code 1).
    Returns (hard [B, Nmax] int32, iters_used [B] int32, ok [B] bool).
    """
    return _decode_gather(llr.float(), bank, max_iters, code_idx)
