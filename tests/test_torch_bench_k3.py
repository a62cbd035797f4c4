"""The host side of tools/bench_k3.py: how it reads K3's SASS and works out
the issue floor, on a small hand-written ``nvdisasm -c`` listing, and the
coded inputs its ``--time`` draws.  The tool itself runs on the card (it
disassembles the built library and times the decoders there)."""

import types

import numpy as np
import pytest
import torch

from gr_dtl_tpu_torch.ops import ldpc, ldpc_cuda
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
    """``--form gather --time``'s calls: each pairs a K8 call with
    _bp_gather on the same tensors, tables and max_iters (on the CPU both
    are the plain version, so they agree), a code's sets through decode and
    a bank's through decode_bank."""
    monkeypatch.setattr(bench_k3, "BANK_SIZES", (1, 2))
    seen = []
    for name in ("decode", "decode_bank"):
        orig = getattr(ldpc, name)
        monkeypatch.setattr(ldpc, name, lambda *a, _o=orig, _n=name, **k: seen.append(_n) or _o(*a, **k))
    code, regimes = bench_k3.regime_inputs(torch.device("cpu"), n=64)
    x, idx, bank = bench_k3.bank_inputs(torch.device("cpu"), 64)[2]
    calls = bench_k3.gather_calls({"knee": (regimes["knee"], code, None, 15), "knee, 0": (regimes["knee"], code, None, 0),
                                   "bank of 2": (x, bank, idx, 15)})
    assert list(calls) == ["knee", "knee, 0", "bank of 2"]
    for k, (k8, plain) in calls.items():
        for a, b in zip(k8(), plain()):
            assert torch.equal(a, b), k
    assert seen == ["decode", "decode", "decode_bank"]
    assert int(calls["knee, 0"][0]()[1].max()) == 0  # max_iters reaches the call


# K8's walk over codewords around the loop of updates: the barriers counted are the update loop's
WALK = SASS.replace("        /*0000*/                   MOV R1, c[0x0][0x28] ;\n",
                    "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n.L_x_9:\n"
                    "        /*0004*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;\n").replace(
    "        /*00d0*/                   EXIT ;\n//", "        /*00c8*/               @P3 BRA `(.L_x_9) ;\n"
                                                  "        /*00d0*/                   EXIT ;\n//", 1)


def test_edge_counts_in_a_walk_over_codewords():
    ins = bench_k3.parse(WALK)["_ZN12_GLOBAL__N_19bp_kernelILb0ELi7EEEvPKf"]
    assert bench_k3.loops(ins) == [(1, 14), (2, 13), (3, 9), (10, 11)]
    c = bench_k3.edge_counts(ins)
    assert c["loops"] == [[3, 9]] and c["per_edge"]["instructions"] == 7.0
    assert c["update_loop_barriers"] == {"bar": 2, "warpsync": 0, "vote": 0}  # the walk's own barrier left out


def test_timeline_summary_by_hand():
    """``--timeline``'s summary on four codewords on three SMs: SM 0 runs
    two back to back (0-100, 100-400 ns), SM 1 one (0-100), SM 2 one
    (50-120); with half of 4 SMs as the bar, fewer than 2 hold a codeword
    from 120 to 400 ns and from 100 to 120 only SMs 0 and 2."""
    rec = np.array([[0, 10, 100, 0 << 32 | 0], [0, 10, 100, 1 << 32 | 0], [100, 110, 400, 0 << 32 | 15],
                    [50, 60, 120, 2 << 32 | 3]])
    got = bench_k3.timeline_summary(rec, 15, sms=4)
    assert got["span_ns"] == 400 and got["tail_ns"] == 280 and got["tail_share"] == 0.7
    assert got["life_ns"] == {"0": 100.0, "1-14": 70.0, "15": 300.0}
    assert got["count"] == {"0": 2, "1-14": 1, "15": 1} and got["sms_used"] == 3
    assert got["prologue_ns"] == 10.0 and got["clock_step_ns"] == 10


def test_variants_and_timelines_hold_their_anchors():
    """Every substitution of ``VARIANTS`` and of the source's own frame in
    ``TIMELINES`` finds its text in the source exactly once, and the
    source's frame is the one ``timeline_library`` picks; the first K8's
    frame (a block a codeword) is the other."""
    text = ldpc_cuda.SOURCE.read_text()
    for name, subs in bench_k3.VARIANTS.items():
        assert all(text.count(old) == 1 for old, _ in subs), name
    assert all(text.count(old) == 1 for old, _ in bench_k3.TIMELINES["walking"])
    assert next(f for f, subs in bench_k3.TIMELINES.items() if all(o in text for o, _ in subs)) == "walking"
    # the tail variant's text holds its own frame, and its subs each once in turn
    tail = next(k for k in bench_k3.VARIANTS if k.startswith("the tail: two passes"))
    two = bench_k3.written(bench_k3.VARIANTS[tail], "test")
    assert all(two.count(old) == 1 for old, _ in bench_k3.TIMELINES["two passes (the tail variant)"])
    assert not all(o in two for o, _ in bench_k3.TIMELINES["walking"])


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


def _outputs(rows: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 6, generator=g)
    return {"inputs": bench_k3.digest(x, None), "hard": (x < 0).int(), "iters": torch.arange(rows, dtype=torch.int32),
            "ok": torch.ones(rows, dtype=torch.bool)}


def test_compare_outputs_counts_rows_in_any_bit():
    """``--same-as``'s comparison of two dumps: a row differing in its hard
    bits, its iterations or ok counts once, however many of them differ."""
    a = {"set": _outputs(8, 0), "other": _outputs(3, 1)}
    b = {k: {n: (t.clone() if torch.is_tensor(t) else t) for n, t in v.items()} for k, v in a.items()}
    assert bench_k3.compare_outputs(a, b) == {"set": 0, "other": 0}
    b["set"]["hard"][1, 2] ^= 1
    b["set"]["iters"][1] += 1
    b["set"]["iters"][4] += 1
    b["set"]["ok"][6] = False
    assert bench_k3.compare_outputs(a, b) == {"set": 3, "other": 0}


def test_compare_outputs_refuses_other_inputs_or_sets():
    a = {"set": _outputs(8, 0)}
    with pytest.raises(ValueError, match="other inputs"):
        bench_k3.compare_outputs(a, {"set": _outputs(8, 2)})
    with pytest.raises(ValueError, match="other sets"):
        bench_k3.compare_outputs(a, {"set": a["set"], "more": a["set"]})
    x = torch.ones(3, 2)
    assert bench_k3.digest(x, None) != bench_k3.digest(x, torch.zeros(3, dtype=torch.int32))
    assert bench_k3.digest(x, None) == bench_k3.digest(x.clone(), None)


def test_variants_are_bound_as_the_checkout_binds(monkeypatch):
    """A variant's library takes the argument types the checkout's own
    ``ldpc_cuda.build`` gives each entry point it has, and ``k8_of`` runs it
    through the public decoders (on the CPU: the plain version)."""
    fn = lambda a, r: types.SimpleNamespace(argtypes=a, restype=r)
    ref = types.SimpleNamespace(bp_decode_launch=fn([1, 2], 3), bp_gather_launch=fn([4], 5),
                                bp_resident_codewords=fn([6, 7], 8))
    lib = types.SimpleNamespace(**{k: fn(None, None) for k in vars(ref)})
    monkeypatch.setattr(ldpc_cuda, "build", lambda: ref)
    bound = bench_k3.bound_like_build(lib)
    assert {k: (v.argtypes, v.restype) for k, v in vars(bound).items()} == {
        "bp_decode_launch": ([1, 2], 3), "bp_gather_launch": ([4], 5), "bp_resident_codewords": ([6, 7], 8)}
    code, regimes = bench_k3.regime_inputs(torch.device("cpu"), n=16)
    got = bench_k3.k8_of(lib, regimes["knee"], code, None, 15)
    for a, b in zip(got, ldpc._bp_gather(regimes["knee"], *ldpc._gather_tables(code, None), 15)):
        assert torch.equal(a, b)
    assert ldpc_cuda.build() is ref  # launching() put the checkout's build back
