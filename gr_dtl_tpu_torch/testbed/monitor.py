"""Telemetry: protobuf envelopes, ZMQ PUB probe, parser and
registry (port of gr_dtl_tpu/testbed/monitor.py).

- :class:`MonitorProto`: makes envelopes, stamping ms timestamps, queue
  depth and a sent counter;
- :class:`MonitorProbe`: message sink publishing over a ZMQ PUB socket,
  or, with ``address=None``, capturing into ``.captured``.  Three
  encodings, told apart by their first byte as the collector's parser
  tells them:
  * ``0x5c`` + a serialized ``MonitorProtoMsg`` (payload in an Any),
  * ``0x07`` pair carrier ``(sent_counter . (nmsgs . proto blob))``: the
    counters ride the carrier, not the envelope,
  * ``0x7b`` (= '{') a JSON dict for self-describing messages;
- :class:`MonitorParser`: collector-side decode back to dicts through a
  proto-id registry.

The receive chain stays on the device and returns telemetry as tensors;
:func:`eq_messages` / :func:`dec_messages` turn a batch of per-frame
values, as numpy (or CPU tensors), into per-frame messages on the host.
The wire format (message names, package ``gr_dtl_tpu``, field numbers) is
the JAX package's, byte for byte.
"""

from __future__ import annotations

import json
import struct
import time
import typing as t

import numpy as np

from gr_dtl_tpu_torch.testbed.proto import monitor_pb2

__all__ = [
    "FEC_DEC_MSG", "EQ_MSG", "system_ts",
    "MonitorProto", "MonitorProbe", "MonitorParser",
    "register_parser", "eq_messages", "dec_messages",
]

# proto ids
FEC_DEC_MSG = 0
EQ_MSG = 1

PROTO_TAG = 0x5C
PAIR_TAG = 0x07  # pmt's serialized-PAIR tag
_PAIR_HDR = struct.Struct(">BQQ")


def system_ts() -> int:
    """Milliseconds since the epoch."""
    return int(time.time() * 1000)


_PAYLOAD_TYPES: dict[int, t.Any] = {
    FEC_DEC_MSG: monitor_pb2.MonitorDecMsg,
    EQ_MSG: monitor_pb2.MonitorEqMsg,
}


def register_parser(proto_id: int, msg_class) -> None:
    """Register a payload type for a proto id."""
    _PAYLOAD_TYPES[proto_id] = msg_class


class MonitorProto:
    """Makes the envelopes of one payload type."""

    def __init__(self, proto_id: int):
        self.proto_id = proto_id
        self.sent_counter = 0

    def build(self, payload_msg, nmsgs: int = 0) -> bytes:
        env = monitor_pb2.MonitorProtoMsg()
        env.time = system_ts()
        env.proto_id = self.proto_id
        env.nmsgs = nmsgs
        self.sent_counter += 1
        env.sent_counter = self.sent_counter
        env.payload.Pack(payload_msg)
        return bytes([PROTO_TAG]) + env.SerializeToString()

    def build_blob(self, payload_msg) -> bytes:
        """Bare serialized envelope, no tag byte: the blob a block hands the
        probe for the pair-carrier encoding (the probe stamps the counters,
        so nmsgs and sent_counter stay unset in this envelope)."""
        env = monitor_pb2.MonitorProtoMsg()
        env.time = system_ts()
        env.proto_id = self.proto_id
        env.payload.Pack(payload_msg)
        return env.SerializeToString()


class MonitorProbe:
    """ZMQ PUB telemetry publisher.

    ``address=None`` runs in capture mode: messages are kept in
    ``.captured`` and nothing needs pyzmq.
    """

    def __init__(self, address: str | None = "tcp://*:5550", bind: bool = True):
        self.captured: list[bytes] = []
        self.sent_counter = 0  # the carrier's counter
        self._sock = None
        if address is not None:
            import zmq

            self._ctx = zmq.Context.instance()
            self._sock = self._ctx.socket(zmq.PUB)
            (self._sock.bind if bind else self._sock.connect)(address)

    def send(self, blob: bytes) -> None:
        if self._sock is not None:
            self._sock.send(blob)
        else:
            self.captured.append(blob)

    def send_dict(self, d: dict) -> None:
        d = dict(d)
        d.setdefault("time", system_ts())
        self.send(json.dumps(d).encode())

    def send_blob(self, blob: bytes, nmsgs: int = 0) -> None:
        """Pair-carrier encoding: wrap a bare envelope blob
        (:meth:`MonitorProto.build_blob`) as ``(sent_counter . (nmsgs .
        blob))``, the probe's own sent counter and the queue depth on the
        carrier."""
        self.sent_counter += 1
        self.send(_PAIR_HDR.pack(PAIR_TAG, self.sent_counter, nmsgs) + blob)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close(0)
            self._sock = None


class MonitorParser:
    """Collector-side decode: sniff the tag byte, return a flat dict."""

    @staticmethod
    def _env_to_dict(env) -> dict:
        out = {
            "time": env.time,
            "proto_id": env.proto_id,
            "nmsgs": env.nmsgs,
            "sent_counter": env.sent_counter,
        }
        cls = _PAYLOAD_TYPES.get(env.proto_id)
        if cls is not None:
            payload = cls()
            env.payload.Unpack(payload)
            for field in payload.DESCRIPTOR.fields:
                out[field.name] = getattr(payload, field.name)
        return out

    def parse(self, blob: bytes) -> dict:
        if not blob:
            return {}
        if blob[0] == PROTO_TAG:
            env = monitor_pb2.MonitorProtoMsg()
            env.ParseFromString(blob[1:])
            return self._env_to_dict(env)
        if blob[0] == PAIR_TAG:
            # the counters come from the carrier
            _tag, counter, nmsgs = _PAIR_HDR.unpack(blob[:_PAIR_HDR.size])
            env = monitor_pb2.MonitorProtoMsg()
            env.ParseFromString(blob[_PAIR_HDR.size:])
            out = self._env_to_dict(env)
            out["nmsgs"] = nmsgs
            out["sent_counter"] = counter
            return out
        return json.loads(blob.decode())


# ---------------------------------------------------------------------------
# per-frame values -> messages (host side)
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """A per-frame array as numpy: numpy as it is, a tensor copied to the
    host (which waits for its device)."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def eq_messages(rx_out, lost_frames_rate: float = 0.0, fec_key: int = 0) -> list:
    """Per-frame MonitorEqMsg payloads from a batch's ``cnst_id``,
    ``snr_db`` and ``noise_var`` (an ``RxOut``, or anything with those
    three attributes as numpy arrays or tensors)."""
    cnst = _host(rx_out.cnst_id)
    snr = _host(rx_out.snr_db)
    noise = _host(rx_out.noise_var)
    return [monitor_pb2.MonitorEqMsg(
        constellation_key=int(cnst[i]),
        fec_key=fec_key,
        estimated_snr_tag_key=float(snr[i]),
        noise_tag_key=float(noise[i]),
        lost_frames_rate=float(lost_frames_rate),
    ) for i in range(cnst.shape[0])]


def dec_messages(rx_out, fec, crc_ok_count: int, crc_fail_count: int) -> list:
    """Per-frame MonitorDecMsg payloads from a coded batch's ``cnst_id``,
    ``avg_iters``, ``payload_len`` and ``frame_no``; ``fec`` is the
    ``models/fec_chain.FecParams`` of the code."""
    from gr_dtl_tpu_torch.ops import constellation as cn

    cnst = _host(rx_out.cnst_id)
    iters = _host(rx_out.avg_iters)
    plen = _host(rx_out.payload_len)
    frame_no = _host(rx_out.frame_no)
    msgs = []
    for i in range(cnst.shape[0]):
        bps = int(cn.BITS_PER_SYMBOL[cnst[i]])
        msgs.append(monitor_pb2.MonitorDecMsg(
            tb_no=int(frame_no[i]),
            tb_payload=int(plen[i]) * 8 + 32,
            tb_code_k=fec.k,
            tb_code_n=fec.n,
            tb_codewords=int(fec.ncws_tab2[1][bps]),  # code 1, as the reference's ncws_tab
            frame_payload=fec.cfg.frame_capacity_symbols * bps if bps else 0,
            bps=bps,
            crc_ok_count=crc_ok_count,
            crc_fail_count=crc_fail_count,
            tber=0,
            avg_it=float(iters[i]),
        ))
    return msgs
