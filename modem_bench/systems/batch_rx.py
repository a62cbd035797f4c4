"""System ``batch_rx``: the batch receiver of ``gr_dtl_tpu_torch``, one
configuration's code (or none), and its comparison with the plain
reference.

A step is ``receiver.detect_and_extract`` over one stream of B frames,
then ``receiver.rx_frames``.  :meth:`Program.staged` runs the same step
as the stages ``rx_frames`` composes (``demodulate``,
``equalize_passes``, ``demap_and_verify`` and, coded,
``fec_chain.fec_frame_decode`` after ``demap_and_verify(...,
defer_fec=True)``), calling ``mark(stage)`` after each, so that a timer
or a profiler can sit at the boundaries.  A traced run holds the staged
step's time to the step's (``run.STAGED_TOLERANCE``).

What a system adapter gives the harness: :func:`modem` (the reference's
constants, which the traffic's transmitter uses too), :class:`Program`
(``stages``, ``build``, ``step``, ``staged``, ``launch_counters``),
:func:`passed` (a step's count of passing frames, on the device),
:func:`reference` and :func:`readings` (the compared numbers of one
stream).
"""

from __future__ import annotations

import torch

from modem_bench import compare
from modem_bench.generator import Stream
from modem_bench.reference import config as refcfg
from modem_bench.reference import modem as ref

STAGES = ("detect", "demodulate", "equalize", "demap")
CODED_STAGES = STAGES + ("fec",)


def code(cell):
    """H of the configuration's one code, or None uncoded: this system
    receives with one code (a bank of codes is another system's)."""
    codes = cell.codes()
    if len(codes) > 1:
        raise SystemExit(f"modem_bench: {cell.config_name}: batch_rx receives with one code, "
                         f"the configuration names {len(codes)}")
    return next(iter(codes.values()), None)


def modem(cell, device) -> ref.Modem:
    return ref.build(refcfg.numerology(cell.config), device, code(cell))


class Program:
    def __init__(self, cell, device):
        from gr_dtl_tpu_torch.models import fec_chain, receiver
        from gr_dtl_tpu_torch.utils import config as cfgmod

        self.receiver, self.fec_chain = receiver, fec_chain
        self.cfg = cfgmod.make_rx_config(dict(cell.config))
        fec = fec_chain.build_fec(self.cfg, code(cell), device) if self.cfg.fec else None
        self.rxp = receiver.build_rx(self.cfg, device, fec)
        self.B = cell.frames_per_step
        self.device = torch.device(device)
        self.stages = CODED_STAGES if self.cfg.fec else STAGES

    def build(self) -> None:
        """Build (or load from the package's build cache) the CUDA libraries
        the step launches, side by side."""
        if self.device.type != "cuda":
            return
        from gr_dtl_tpu_torch.ops import _cuda_build, equalizer_cuda, ldpc_cuda, sync_cuda

        _cuda_build.build_all(sync_cuda.build, equalizer_cuda.build, *((ldpc_cuda.build,) if self.cfg.fec else ()))

    def step(self, stream: torch.Tensor):
        """(frames, eps, RxOut) of one stream."""
        frames, eps = self.receiver.detect_and_extract(stream, self.cfg, self.B)
        return frames, eps, self.receiver.rx_frames(self.rxp, frames)

    def staged(self, stream: torch.Tensor, mark):
        """:meth:`step` stage by stage, ``mark(stage)`` after each."""
        rx, rxp = self.receiver, self.rxp
        frames, eps = rx.detect_and_extract(stream, self.cfg, self.B)
        mark("detect")
        spectra, carr_off, taps = rx.demodulate(rxp, frames)
        mark("demodulate")
        pay_eq, fields, header_ok, cnst = rx.equalize_passes(rxp, spectra, taps)
        mark("equalize")
        if not self.cfg.fec:
            out = rx.demap_and_verify(rxp, pay_eq, fields, header_ok, cnst, carr_off)
            mark("demap")
            return frames, eps, out
        out, fec_in = rx.demap_and_verify(rxp, pay_eq, fields, header_ok, cnst, carr_off, defer_fec=True)
        mark("demap")
        fec = rxp.fec
        dec = self.fec_chain.fec_frame_decode(fec, fec_in["llrs"], cnst, fec_in["tb_payload"],
                                              fec_id=fec_in["fec_id"] if fec.n_codes > 1 else None)
        mark("fec")
        return frames, eps, out._replace(payload=dec.payload, payload_len=dec.payload_len,
                                         crc_ok=dec.crc_ok & header_ok, fec_ok=dec.fec_ok,
                                         avg_iters=dec.avg_iters)

    @staticmethod
    def launch_counters() -> dict:
        """The kernels' own launch counters (``LAUNCHES`` of each wrapper)."""
        from gr_dtl_tpu_torch.ops import equalizer_cuda, ldpc_cuda, sync_cuda

        return {"sync_metric": sync_cuda.timing_metric_cuda.LAUNCHES,
                "equalizer": equalizer_cuda.equalize_frame_cuda.LAUNCHES,
                "ldpc_bp": ldpc_cuda.bp_decode_cuda.LAUNCHES}


def passed(out) -> torch.Tensor:
    """Frames of a step's output (program's or reference's) that pass their CRC."""
    return out[2].crc_ok.sum()


def reference(m: ref.Modem, stream: torch.Tensor, B: int, block: int, control: bool = False):
    """The reference receiver over one stream: (frames, eps, RxOut), the
    frames received ``block`` at a time.  ``control``: one precision below
    the float32 the modem states: the stream's samples read as bfloat16
    before detection, and every float32 matmul of the receive path with
    TF32 operands."""
    if control:
        stream = torch.view_as_complex(torch.view_as_real(stream).to(torch.bfloat16).float().contiguous())
    frames, eps = ref.detect(stream, m.num, B)
    outs = [ref.rx_frames(m, frames[i:i + block], control) for i in range(0, B, block)]
    return frames, eps, ref.RxOut(*(torch.cat(col) for col in zip(*outs)))


def readings(prog, refd, sent: Stream, cell) -> dict:
    """The compared numbers of one stream (``compare``'s list).  ``prog``,
    ``refd``: (frames, eps, RxOut) of the program and of the reference."""
    (pf, pe, po), (rf, re_, ro) = prog, refd
    differ = lambda a, b: int((a != b).sum())
    hdr = ((po.header_ok != ro.header_ok) | (po.frame_no != ro.frame_no) | (po.cnst_id != ro.cnst_id)
           | (po.feedback_cnst != ro.feedback_cnst))
    pay = ((po.crc_ok != ro.crc_ok) | (po.payload_len != ro.payload_len)
           | (po.crc_ok & ro.crc_ok & (po.payload != ro.payload).any(1)))
    wrong = (po.payload_len != sent.payload_len) | (po.payload != sent.payload).any(1)
    soft = compare.frame_errors(po.soft_syms, ro.soft_syms)
    snr = (po.snr_db - ro.snr_db).abs()
    r = {"frames_rel_err": float(compare.frame_errors(pf, rf).max()),
         "eps_abs_err": float((pe - re_).abs().max()),
         "carr_off_diff": differ(po.carr_offset, ro.carr_offset), "header_diff": int(hdr.sum()),
         "snr_db_err_median": float(snr.median()),
         "snr_diverged": int((~(snr <= compare.SNR_DIVERGED_DB)).sum()),
         "soft_err_median": float(soft.median()),
         "soft_diverged": int((~(soft <= compare.SOFT_DIVERGED)).sum()),
         "payload_diff": int(pay.sum()), "false_accepts": int((po.crc_ok & wrong).sum())}
    if cell.coded:
        r["fec_ok_diff"] = differ(po.fec_ok, ro.fec_ok)
        r["bp_iters_diff"] = differ(po.avg_iters, ro.avg_iters)
    return r
