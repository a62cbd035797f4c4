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
