"""The testbed's host side, port against the JAX package: the telemetry
envelopes and their parser, the per-frame messages, the
collector's aggregation, the frame store's file, and the logging
registry.

Bytes, ints and strings must be equal; the messages read float32
values into float64 fields, so those are equal too (the same float32 in,
the same double out).  ``system_ts`` is pinned to one value in both
packages, so the envelopes' timestamps are equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_dtl_tpu.models import fec_chain as ref_fec_chain
from gr_dtl_tpu.testbed import collect as ref_collect
from gr_dtl_tpu.testbed import frame_store as ref_frame_store
from gr_dtl_tpu.testbed import monitor as ref_monitor
from gr_dtl_tpu.utils import config as ref_config
from gr_dtl_tpu.utils import logging as ref_logging

from gr_dtl_tpu_torch.models import fec_chain, receiver
from gr_dtl_tpu_torch.testbed import collect, frame_store, monitor
from gr_dtl_tpu_torch.utils import alist, config
from gr_dtl_tpu_torch.utils import logging as dtl_logging

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TS = 1_760_000_000_123


@pytest.fixture
def pinned_ts(monkeypatch):
    for mod in (ref_monitor, monitor):
        monkeypatch.setattr(mod, "system_ts", lambda: TS)


def _eq_payloads(pb2):
    return [pb2.MonitorEqMsg(constellation_key=c, fec_key=f, estimated_snr_tag_key=s,
                             noise_tag_key=n, lost_frames_rate=r)
            for c, f, s, n, r in ((3, 1, 17.25, 0.01, 0.125), (1, 0, -3.5, 1.5e-3, 0.0),
                                  (4, 2, float(np.float32(31.123)), 2e-6, 1.0))]


def _encode(mod, encoding):
    """Every payload of _eq_payloads through one encoding: the probe's
    captured blobs."""
    probe = mod.MonitorProbe(address=None)
    envelopes = mod.MonitorProto(mod.EQ_MSG)
    for i, p in enumerate(_eq_payloads(mod.monitor_pb2)):
        if encoding == "envelope":
            probe.send(envelopes.build(p, nmsgs=i))
        elif encoding == "pair":
            probe.send_blob(envelopes.build_blob(p), nmsgs=2 * i + 1)
        else:
            probe.send_dict({"proto_id": mod.EQ_MSG, "crc_ok": bool(i % 2), "snr": p.estimated_snr_tag_key})
    return probe.captured


@pytest.mark.parametrize("encoding", ["envelope", "pair", "json"])
def test_encodings_are_the_references_bytes_and_parse_alike(pinned_ts, encoding):
    got, want = _encode(monitor, encoding), _encode(ref_monitor, encoding)
    assert got == want
    tag = {"envelope": monitor.PROTO_TAG, "pair": monitor.PAIR_TAG, "json": ord("{")}[encoding]
    assert [b[0] for b in got] == [tag] * 3
    for blob in got:
        assert monitor.MonitorParser().parse(blob) == ref_monitor.MonitorParser().parse(blob)
    assert monitor.MonitorParser().parse(b"") == {}


def test_registered_payload_types_parse_alike(pinned_ts):
    """A payload registered for a new proto id unpacks in both parsers."""
    from gr_dtl_tpu_torch.testbed.proto import monitor_pb2

    for mod in (monitor, ref_monitor):
        mod.register_parser(7, monitor_pb2.MonitorDecMsg)
    try:
        blob = monitor.MonitorProto(7).build(monitor_pb2.MonitorDecMsg(tb_no=5, bps=2, avg_it=1.5))
        got, want = monitor.MonitorParser().parse(blob), ref_monitor.MonitorParser().parse(blob)
        assert got == want and got["tb_no"] == 5 and got["proto_id"] == 7
    finally:
        for mod in (monitor, ref_monitor):
            mod._PAYLOAD_TYPES.pop(7)


class _Batch:
    """The per-frame fields eq_messages and dec_messages read."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _frames(rng, B):
    return dict(cnst_id=rng.randint(1, 5, B).astype(np.int32),
                snr_db=rng.uniform(-5, 40, B).astype(np.float32),
                noise_var=rng.uniform(1e-5, 1, B).astype(np.float32),
                avg_iters=rng.uniform(0, 15, B).astype(np.float32),
                payload_len=rng.randint(0, 300, B).astype(np.int32),
                frame_no=rng.randint(0, 4096, B).astype(np.int32))


@pytest.mark.parametrize("as_tensors", [False, True])
def test_eq_messages_equal_the_references(as_tensors):
    f = _frames(np.random.RandomState(1), 37)
    port = _Batch(**{k: torch.as_tensor(v) if as_tensors else v for k, v in f.items()})
    got = monitor.eq_messages(port, 0.0625, fec_key=3)
    want = ref_monitor.eq_messages(_Batch(**f), 0.0625, fec_key=3)
    assert [m.SerializeToString() for m in got] == [m.SerializeToString() for m in want]
    assert got[5].estimated_snr_tag_key == float(f["snr_db"][5])


def test_dec_messages_equal_the_references():
    """Field for field over a code bank's FEC tables (bps 1..4 and the
    capacity of each), at both the port's FecParams and the reference's dict."""
    names = ("n_0100_k_0027.alist", "n_0300_k_0152.alist")
    cfg = config.make_tx_config(None, frame_length=10, fec=True)
    ref_cfg = ref_config.make_tx_config(None, frame_length=10, fec=True)
    Hs = [alist.load_alist(str(EXAMPLES / n)) for n in names]
    fec = fec_chain.build_fec(cfg, Hs, "cpu")
    ref_fec = ref_fec_chain.build_fec(ref_cfg, Hs)
    f = _frames(np.random.RandomState(2), 29)
    got = monitor.dec_messages(_Batch(**{k: torch.as_tensor(v) for k, v in f.items()}), fec, 17, 4)
    want = ref_monitor.dec_messages(_Batch(**f), ref_fec, 17, 4)
    assert [m.SerializeToString() for m in got] == [m.SerializeToString() for m in want]
    assert {m.bps for m in got} == {1, 2, 3, 4}


def _feed(mod, col_mod):
    """A collector fed the same stream: EQ messages with a gap in the
    counters, DEC messages, JSON dicts."""
    b_eq, b_dec = mod.MonitorProto(mod.EQ_MSG), mod.MonitorProto(mod.FEC_DEC_MSG)
    pb2 = mod.monitor_pb2
    col = col_mod.Collector(keep=6)
    for i, snr in enumerate((10.0, 12.0, 14.0, 16.0, 9.5)):
        blob = b_eq.build(pb2.MonitorEqMsg(constellation_key=2, estimated_snr_tag_key=snr,
                                           noise_tag_key=0.01 * (i + 1)))
        if i != 2:  # lost on the monitoring channel
            col.feed(blob)
    for ok, fail in ((5, 0), (9, 1)):
        col.feed(b_dec.build(pb2.MonitorDecMsg(crc_ok_count=ok, crc_fail_count=fail, bps=2)))
    col.feed_dict({"crc_ok": True, "snr": 3.0})
    return col


def test_collector_summary_and_frame_success_equal_the_references(pinned_ts, tmp_path):
    got, want = _feed(monitor, collect), _feed(ref_monitor, ref_collect)
    assert got.lost() == want.lost() == 1
    assert got.messages == want.messages and len(got.messages) == 6  # keep=6
    assert got.summary() == want.summary()
    assert got.by_proto(monitor.EQ_MSG) == want.by_proto(ref_monitor.EQ_MSG)
    msgs = [{"crc_ok": True}, {"crc_ok": False}, {"crc_ok": True}, {"x": "y"}]
    assert collect.frame_success(msgs) == ref_collect.frame_success(msgs) == 2 / 3
    assert collect.frame_success([]) is ref_collect.frame_success([]) is None
    assert collect.summarize(msgs + [{"v": 1}, {"v": 4}]) == ref_collect.summarize(msgs + [{"v": 1}, {"v": 4}])
    path = tmp_path / "capture.jsonl"
    path.write_text("\n".join(json.dumps(m) for m in got.messages) + "\n\n")
    assert collect.load_jsonl(str(path)) == ref_collect.load_jsonl(str(path)) == got.messages


def _store_frames(store_mod, path, batches):
    with store_mod.FrameStore(str(path)) as st:
        # the 12-bit number wraps, repeats and jumps back
        for no, n in ((4090, 3), (4094, 5), (1, 2), (1, 9), (3000, 4), (2, 7), (5, 0)):
            st.store(bytes(range(n)), no)
        for out, valid in batches:
            st.store_batch(out, valid)
    return path.read_bytes()


def test_frame_store_file_is_the_references_bytes(tmp_path):
    """The same frames give the same file, the port's batches as RxOuts of
    tensors, the reference's as numpy; read back alike."""
    rng = np.random.RandomState(3)
    B, maxb = 12, 40
    fields = {"payload": rng.randint(0, 256, (B, maxb)).astype(np.uint8),
              "payload_len": rng.randint(0, maxb, B).astype(np.int32),
              "frame_no": ((np.arange(B) + 6) % 4096).astype(np.int32),
              "crc_ok": rng.rand(B) > 0.3}
    valid = rng.rand(B) > 0.2
    zeros = torch.zeros(B)
    out = receiver.RxOut(**{k: torch.as_tensor(v) for k, v in fields.items()},
                         **{k: zeros for k in receiver.RxOut._fields if k not in fields})
    got = _store_frames(frame_store, tmp_path / "port.bin", [(out, torch.as_tensor(valid)), (out, None)])
    want = _store_frames(ref_frame_store, tmp_path / "ref.bin", [(_Batch(**fields), valid),
                                                                 (_Batch(**fields), None)])
    assert got == want and len(got) > 100
    recs = list(frame_store.read_frames(str(tmp_path / "port.bin")))
    assert recs == list(ref_frame_store.read_frames(str(tmp_path / "ref.bin")))
    assert recs[0] == (4090, bytes(range(3)))


def test_logging_registry_behaves_as_the_references(monkeypatch, capsys):
    monkeypatch.setenv("GR_DTL_TPU_LOG_LEVEL", "INFO")
    lg, ref_lg = dtl_logging.get_logger("port_test"), ref_logging.get_logger("port_test")
    assert lg is dtl_logging.get_logger("port_test") and lg.name == "gr_dtl_tpu_torch.port_test"
    assert lg.level == ref_lg.level == 20 and not lg.propagate
    assert "port_test" in dtl_logging.registry()
    lg.info("hello from the port")
    assert "gr_dtl_tpu_torch.port_test:INFO hello from the port" in capsys.readouterr().out
    dtl_logging.set_log_level("ERROR")
    ref_logging.set_log_level("ERROR")
    assert lg.level == ref_lg.level == 40
    monkeypatch.setenv("GR_DTL_TPU_LOG", "0")
    off = dtl_logging.get_logger("port_test_off")
    assert off.level == ref_logging.get_logger("port_test_off").level > 50
