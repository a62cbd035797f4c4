"""Streaming transport-block reassembly on the GPU: the two CUDA kernels of
``csrc/tb_ring.cu`` and their wrapper.

``tb_reassemble_cuda`` stands for the ``lax.scan`` of
``gr_dtl_tpu/models/fec_chain.py::tb_reassemble`` (step at :211-231); its
plain PyTorch version is ``models/fec_chain.py::_tb_reassemble_torch``.  The
first kernel finds every slot's source row before every frame by block-wide
prefix-maxes (of the ok, ``is_new`` and each slot's frame indices; a block
a ring), the second copies the LLR rows: what binds the pair is the copy's
bytes and two launches.  The library is built at first use
(``ops/_cuda_build``); importing this module needs neither ``nvcc`` nor a
GPU.  The wrapper takes one ring or S rings (the streams of a sharded
session's rank) in the same two launches, launches on PyTorch's current
stream, allocates its outputs and the source table with ``torch.empty``,
never synchronises, and counts its kernel launches (two a call) in
``tb_reassemble_cuda.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from gr_dtl_tpu_torch.ops import _cuda_build

__all__ = ["build", "library_path", "tb_reassemble_cuda", "tb_bytes", "MAX_W"]

SOURCE = _cuda_build.PKG / "csrc" / "tb_ring.cu"
NVCC_FLAGS = _cuda_build.NVCC_FLAGS
MAX_W = 32  # kMaxW of the source


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tb_ring_walk_launch.argtypes = [p] * 11 + [i] * 8 + [p] * 9
    lib.tb_ring_walk_launch.restype = i
    lib.tb_ring_copy_launch.argtypes = [p, p, p, i, i, i, i, p, p, p]
    lib.tb_ring_copy_launch.restype = i
    return lib


def tb_bytes(F: int, W: int, max_f: int, S: int = 1) -> int:
    """Bytes the reassembly must move for F frames of each of S rings: the
    F input rows, the carried buffer and the header records read once; the
    emitted rows, the new carry and the emitted scalars written once."""
    llr_rows = (F + W) + (F + 1) * W  # read + written, max_f float32 each
    records = (5 * 4 + 1) * F + (4 * 4 + 1) * F  # five int32 and ok read, four int32 and valid written
    carry = 2 * (4 * 4 + W)  # four int32 scalars and present [W], in and out
    return S * (4 * max_f * llr_rows + records + carry)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"tb_reassemble_cuda needs CUDA tensors, got {name} on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"tb_reassemble_cuda needs {name} as a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def tb_reassemble_cuda(state, llrs: torch.Tensor, tb_no: torch.Tensor, tb_offset: torch.Tensor,
                       cnst_id: torch.Tensor, tb_payload: torch.Tensor, fec_id: torch.Tensor,
                       ok: torch.Tensor, frame_bits_of_cnst):
    """One block of frames through the TB ring, or through each of S rings,
    in two launches.

    Args:
      state: the carry, ``(tb_no, llrs [W, maxF], present [W], cnst, plen,
             fec_id)``: int32 scalars (0-dim), float32, bool, on the GPU;
             for S rings every leaf has a leading [S] (the scalars [S]).
      llrs:  [F, maxF] float32 per-frame LLR streams ([S, F, maxF]).
      tb_no/tb_offset/cnst_id/tb_payload/fec_id: [F] ([S, F]) int32 header fields.
      ok:    [F] ([S, F]) bool, header CRC ok (gates everything).
      frame_bits_of_cnst: five ints, the bits of one frame for
             constellation ids 0..4 (the slot of a frame is its
             ``tb_offset`` over this).
    Returns (state', emitted): state' as ``state`` (fresh tensors; the
    scalars are views of one [4] ([4, S]) tensor), emitted a dict of
    ``llrs`` [F, W, maxF] float32, ``cnst``/``plen``/``fec_id``/``tb_no`` [F]
    int32, ``valid`` [F] bool (each with the leading [S] for S rings).
    """
    c_tb, c_llrs, c_present, c_cnst, c_plen, c_fec = state
    if llrs.ndim not in (2, 3) or c_llrs.ndim != llrs.ndim:
        raise ValueError("tb_reassemble_cuda needs llrs [F, maxF] and a carried buffer [W, maxF], "
                         "or [S, F, maxF] and [S, W, maxF]")
    lead = tuple(llrs.shape[:-2])
    S = lead[0] if lead else 1
    (F, max_f), W = llrs.shape[-2:], c_llrs.shape[-2]
    if not 1 <= W <= MAX_W:
        raise ValueError(f"tb_reassemble_cuda takes 1..{MAX_W} slots, got {W}")
    if S < 1:
        raise ValueError("tb_reassemble_cuda needs at least one ring")
    _check("llrs", llrs, torch.float32, lead + (F, max_f))
    _check("state.llrs", c_llrs, torch.float32, lead + (W, max_f))
    _check("state.present", c_present, torch.bool, lead + (W,))
    for name, t in (("state.tb_no", c_tb), ("state.cnst", c_cnst), ("state.plen", c_plen),
                    ("state.fec_id", c_fec)):
        _check(name, t, torch.int32, lead)
    for name, t in (("tb_no", tb_no), ("tb_offset", tb_offset), ("cnst_id", cnst_id),
                    ("tb_payload", tb_payload), ("fec_id", fec_id)):
        _check(name, t, torch.int32, lead + (F,))
    _check("ok", ok, torch.bool, lead + (F,))
    fb = [int(v) for v in frame_bits_of_cnst]
    if len(fb) != 5:
        raise ValueError("frame_bits_of_cnst must hold five values (constellation ids 0..4)")

    dev = llrs.device
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    state_out, src = i32(4, *lead), i32(*lead, F + 1, W)
    e_cnst, e_plen, e_fec, e_tb = (i32(*lead, F) for _ in range(4))
    e_valid = torch.empty(lead + (F,), dtype=torch.bool, device=dev)
    present_out = torch.empty(lead + (W,), dtype=torch.bool, device=dev)
    e_llrs = torch.empty(lead + (F, W, max_f), dtype=torch.float32, device=dev)
    llrs_out = torch.empty(lead + (W, max_f), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tb_ring_walk_launch(
            c_tb.data_ptr(), c_cnst.data_ptr(), c_plen.data_ptr(), c_fec.data_ptr(),
            c_present.data_ptr(), tb_no.data_ptr(), tb_offset.data_ptr(), cnst_id.data_ptr(),
            tb_payload.data_ptr(), fec_id.data_ptr(), ok.data_ptr(), S, F, W, *fb,
            state_out.data_ptr(), present_out.data_ptr(), e_cnst.data_ptr(), e_plen.data_ptr(),
            e_fec.data_ptr(), e_tb.data_ptr(), e_valid.data_ptr(), src.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"tb_ring_walk_launch failed: CUDA error {rc}")
        tb_reassemble_cuda.LAUNCHES += 1
        rc = lib.tb_ring_copy_launch(
            src.data_ptr(), llrs.data_ptr(), c_llrs.data_ptr(), S, F, W, max_f,
            e_llrs.data_ptr(), llrs_out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"tb_ring_copy_launch failed: CUDA error {rc}")
        tb_reassemble_cuda.LAUNCHES += 1
    new_state = (state_out[0], llrs_out, present_out, state_out[1], state_out[2], state_out[3])
    return new_state, {"llrs": e_llrs, "cnst": e_cnst, "plen": e_plen, "fec_id": e_fec,
                       "tb_no": e_tb, "valid": e_valid}


tb_reassemble_cuda.LAUNCHES = 0
