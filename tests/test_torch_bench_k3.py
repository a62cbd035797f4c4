"""The host side of tools/bench_k3.py: how it reads K3's SASS and works out
the issue floor, on a small hand-written ``nvdisasm -c`` listing, and the
coded inputs its ``--time`` draws.  The tool itself runs on the card (it
disassembles the built library and times the decoders there)."""

import pytest
import torch

from gr_dtl_tpu_torch.ops import ldpc
from gr_dtl_tpu_torch.tools import bench_k3

# an outer loop of updates (two block barriers) around an inner loop that
# evaluates two MUFU.EX2 and one MUFU.RCP a trip, and a loop with no MUFU
SASS = """
//--------------------- .text._ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf --------------------------
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_0:
        /*0020*/                   LDS R2, [R3] ;
        /*0030*/                   MUFU.EX2 R4, R2 ;
        /*0040*/                   MUFU.RCP R5, R4 ;
        /*0050*/                   FFMA R6, R5, R4, R2 ;
        /*0060*/                   MUFU.EX2 R7, R6 ;
        /*0070*/                   STS [R3], R7 ;
        /*0080*/               @P0 BRA `(.L_x_0) ;
.L_x_2:
        /*0090*/                   LDS R8, [R9] ;
        /*00a0*/              @!P2 BRA `(.L_x_2) ;
        /*00b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00c0*/               @P1 BRA `(.L_x_1) ;
        /*00d0*/                   EXIT ;
//--------------------- .text._ZN12_GLOBAL__N_14probeEv --------------------------
        /*0000*/                   EXIT ;
"""


def test_parse_and_loops():
    kernels = bench_k3.parse(SASS)
    assert list(kernels) == ["_ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf", "_ZN12_GLOBAL__N_14probeEv"]
    ins = kernels["_ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf"]
    assert len(ins) == 14 and [op for op, _, _ in ins[2:4]] == ["LDS", "MUFU.EX2"]
    assert ins[9][0] == "LDS" and ins[9][2] == [".L_x_2"]  # a label rides on the instruction after it
    assert ins[10][0] == "BRA" and ins[10][1].startswith("@!P2")  # a predicate is not the opcode
    assert bench_k3.loops(ins) == [(1, 12), (2, 8), (9, 10)]


def test_edge_counts_and_floor():
    c = bench_k3.edge_counts(bench_k3.parse(SASS)["_ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf"])
    # the MUFU loop: 7 instructions and 2 EX2 a trip, so an edge (2 EX2) issues 7
    assert c["loops"] == [[2, 8]]
    assert c["per_edge"] == {"instructions": 7.0, "mufu": 3.0, "lds": 1.0, "sts": 1.0}
    assert c["update_loop_barriers"] == {"bar": 2, "warpsync": 0, "vote": 0}
    assert c["kernel_instructions"] == 14
    # 100 instructions an edge, 900 edges, 10 updates on 132 x 4 x 32 lanes at 1980 MHz
    want = 100 * 900 * 10 / (132 * 4 * 32 * 1980e6) * 1e3
    assert bench_k3.issue_floor_ms(100, 900, 10, 1980.0) == pytest.approx(want, rel=1e-12)


def test_edge_counts_refuses_sass_without_ex2():
    with pytest.raises(ValueError, match="EX2"):
        bench_k3.edge_counts(bench_k3.parse(SASS)["_ZN12_GLOBAL__N_14probeEv"])


def test_coded_inputs_capture_the_step_bp_input():
    """``--time``'s coded inputs: the LLRs a receive step hands decode_mm at
    each SNR, one row a codeword slot (13 a frame of the demo code), with
    decode_mm put back afterwards."""
    decode_mm = ldpc.decode_mm
    code, coded = bench_k3.coded_inputs(torch.device("cpu"), frames=4)
    assert ldpc.decode_mm is decode_mm
    assert list(coded) == ["coded 25 dB", "coded 11 dB"]
    for x in coded.values():
        assert x.dtype == torch.float32 and x.is_contiguous() and tuple(x.shape) == (4 * 13, code.N)
    assert not torch.equal(*coded.values())  # the noise scales with the SNR


# K8's kernel beside K3's in one listing: the same loops, one MUFU.EX2 an edge (tanhf's)
_K3, _PROBE = SASS.split("//--------------------- .text._ZN12_GLOBAL__N_14probeEv")
BOTH = _K3 + _K3.replace("19bp_kernelILb0ELi7EE", "116bp_gather_kernelILi7EE") + \
    "//--------------------- .text._ZN12_GLOBAL__N_14probeEv" + _PROBE


@pytest.mark.parametrize("form, name, per_edge", [
    ("k3", "_ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf", 7.0),
    ("gather", "_ZN12_GLOBAL__N_116bp_gather_kernelILi7EEEvPKf", 3.5)])
def test_form_counts(form, name, per_edge):
    """``--form``'s kernels: each form picks its own kernel out of a
    library's listing (K3's name is no part of K8's) and counts an edge by
    its MUFU.EX2: 2 for K3 (tanhf, expf), 1 for K8 (tanhf)."""
    kernels = bench_k3.parse(BOTH)
    assert len(kernels) == 3
    counts = bench_k3.form_counts(kernels, form)
    assert list(counts) == [name]
    c = counts[name]
    assert c["loops"] == [[2, 8]] and c["per_edge"]["instructions"] == per_edge
    assert c["per_edge"]["mufu"] == 3.0 * per_edge / 7.0
    assert bench_k3.FORMS[form][1] * 7 / 2 == per_edge


def test_gather_calls_pair_k8_with_its_plain_version(monkeypatch):
    """``--form gather --time``'s inputs: each pairs a K8 call with
    _bp_gather on the same tensors and tables (on the CPU both are the
    plain version, so they agree), the regimes through decode and the
    banks through decode_bank."""
    monkeypatch.setattr(bench_k3, "BANK_SIZES", (1, 2))
    seen = []
    for name in ("decode", "decode_bank"):
        orig = getattr(ldpc, name)
        monkeypatch.setattr(ldpc, name, lambda *a, _o=orig, _n=name, **k: seen.append(_n) or _o(*a, **k))
    calls = bench_k3.gather_calls(torch.device("cpu"))
    assert list(calls) == ["2048 clean", "2048 knee", "2048 waterfall", "bank of 1 codes, 1024 codewords",
                           "bank of 2 codes, 1024 codewords"]
    for k in ("2048 knee", "bank of 2 codes, 1024 codewords"):
        k8, plain = calls[k]
        for a, b in zip(k8(), plain()):
            assert torch.equal(a, b), k
    assert seen == ["decode", "decode_bank"]


# a loop the compiler unswitched: a predicated branch to the first update's copy (no message
# load), the other copy jumping over it unconditionally to where both merge
UNSWITCHED = """
//--------------------- .text._ZN12_GLOBAL__N_116bp_gather_kernelILi1EEEvPKf --------------------------
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/               @P1 BRA `(.L_x_1) ;
        /*0030*/                   LDS R4, [R5] ;
        /*0040*/                   MUFU.EX2 R6, R2 ;
        /*0050*/                   FADD R6, R6, R4 ;
        /*0060*/                   BRA `(.L_x_2) ;
.L_x_1:
        /*0070*/                   MUFU.EX2 R6, R2 ;
        /*0080*/                   FMUL R6, R6, 0.5 ;
.L_x_2:
        /*0090*/                   MUFU.RCP R7, R6 ;
        /*00a0*/                   STS [R3], R7 ;
        /*00b0*/               @P0 BRA `(.L_x_0) ;
        /*00c0*/                   EXIT ;
"""


def test_edge_counts_leave_out_the_unswitched_copy():
    """An update that reads its messages runs the loop less the copy an
    unconditional forward branch jumps over: 9 of its 11 instructions, one
    MUFU.EX2 (K8's tanhf) an edge."""
    ins = bench_k3.parse(UNSWITCHED)["_ZN12_GLOBAL__N_116bp_gather_kernelILi1EEEvPKf"]
    assert bench_k3.loops(ins) == [(1, 11)]
    assert bench_k3.skipped(ins, 1, 11) == {7, 8}
    c = bench_k3.edge_counts(ins, bench_k3.FORMS["gather"][1])
    assert c["skipped"] == 2 and c["loops"] == [[1, 11]]
    assert c["per_edge"] == {"instructions": 9.0, "mufu": 2.0, "lds": 2.0, "sts": 1.0}
    # a loop with no such branch is counted whole (K3's)
    assert bench_k3.skipped(bench_k3.parse(SASS)["_ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf"], 1, 12) == set()
