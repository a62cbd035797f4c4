# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: monitor.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rmonitor.proto\x12\ngr_dtl_tpu\x1a\x19google/protobuf/any.proto\"\xac\x01\n\x0fMonitorProtoMsg\x12\x0c\n\x04time\x18\x01 \x01(\x03\x12\x10\n\x08proto_id\x18\x02 \x01(\x05\x12\x0f\n\x05nmsgs\x18\x03 \x01(\x05H\x00\x12\x16\n\x0csent_counter\x18\x04 \x01(\x03H\x01\x12%\n\x07payload\x18\x05 \x01(\x0b\x32\x14.google.protobuf.AnyB\x10\n\x0eoptional_nmsgsB\x17\n\x15optional_sent_counter\"\xde\x01\n\rMonitorDecMsg\x12\r\n\x05tb_no\x18\x01 \x01(\x05\x12\x12\n\ntb_payload\x18\x02 \x01(\x05\x12\x11\n\ttb_code_k\x18\x03 \x01(\x05\x12\x11\n\ttb_code_n\x18\x04 \x01(\x05\x12\x14\n\x0ctb_codewords\x18\x05 \x01(\x05\x12\x15\n\rframe_payload\x18\x06 \x01(\x05\x12\x0b\n\x03\x62ps\x18\x07 \x01(\x05\x12\x14\n\x0c\x63rc_ok_count\x18\x08 \x01(\x05\x12\x16\n\x0e\x63rc_fail_count\x18\t \x01(\x05\x12\x0c\n\x04tber\x18\n \x01(\x05\x12\x0e\n\x06\x61vg_it\x18\x0b \x01(\x01\"\x8a\x01\n\x0cMonitorEqMsg\x12\x19\n\x11\x63onstellation_key\x18\x01 \x01(\x05\x12\x0f\n\x07\x66\x65\x63_key\x18\x02 \x01(\x05\x12\x1d\n\x15\x65stimated_snr_tag_key\x18\x03 \x01(\x01\x12\x15\n\rnoise_tag_key\x18\x04 \x01(\x01\x12\x18\n\x10lost_frames_rate\x18\x05 \x01(\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'monitor_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MONITORPROTOMSG._serialized_start=57
  _MONITORPROTOMSG._serialized_end=229
  _MONITORDECMSG._serialized_start=232
  _MONITORDECMSG._serialized_end=454
  _MONITOREQMSG._serialized_start=457
  _MONITOREQMSG._serialized_end=595
# @@protoc_insertion_point(module_scope)
