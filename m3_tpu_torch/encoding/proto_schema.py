"""Protobuf descriptor bridge for the proto value codec.

Equivalent of the reference's descriptor-driven proto encoding
(`src/dbnode/encoding/proto/encoder.go` parses real protobuf schemas;
the schema travels as a FileDescriptorSet annotation and nested
messages compress field-by-field).  The columnar codec in
``proto_codec.py`` stays the compression engine; this module maps real
protobuf message descriptors onto its (name, kind) schema:

* scalar fields map directly (ints/enums/bool -> INT, float/double ->
  FLOAT, string/bytes -> BYTES so they ride the byte-field LRU);
* NESTED message fields flatten to dotted column names
  (``outer.inner.value``), arbitrarily deep — the columnar model's
  answer to the reference's recursive custom marshal;
* the schema annotation is a serialized FileDescriptorSet plus the
  fully-qualified message name (``pack_schema_annotation``), the same
  payload shape the reference stores, so it can ride the codec
  annotation path (commitlog annotations / M3TSZ first-datapoint
  annotations);
* REPEATED fields, MAPS, and ``oneof`` groups ride OPAQUE BYTES
  columns: the field (or the oneof's set branch) serializes to its own
  proto wire bytes (deterministic map ordering) and compresses through
  the byte-field LRU — the role of the reference's "remaining fields"
  custom marshal (`encoder.go` marshals non-custom fields as a delta'd
  proto blob) rather than per-element columns, which would break the
  dense-column device contract.

The port's copy of ``m3_tpu/encoding/proto_schema.py``.  ``google.protobuf``
is imported only inside the functions that need a descriptor, so the
module imports, and packs and unpacks schema annotations, where no
protobuf package is installed.
"""

from __future__ import annotations

import struct

from m3_tpu_torch.encoding.proto_codec import FieldKind, Schema


class UnsupportedFieldError(ValueError):
    pass


def _real_oneofs(desc):
    """Declared oneof groups only: proto3 `optional` fields synthesize a
    single-member oneof named `_<field>` — those are plain presence
    tracking and must keep their native scalar columns, not an opaque
    blob (the python descriptor API exposes no is_synthetic flag; the
    protoc naming contract is the detection)."""
    return [o for o in desc.oneofs
            if not (len(o.fields) == 1
                    and o.name == "_" + o.fields[0].name)]


def _optional_fields(desc) -> set:
    """Field names with proto3 `optional` presence (synthetic oneofs):
    they ride their native column PLUS a `<name>@set` bool column so
    unset-vs-explicit-default survives the round trip."""
    return {o.fields[0].name for o in desc.oneofs
            if len(o.fields) == 1 and o.name == "_" + o.fields[0].name}


def _kind_for(field) -> FieldKind:
    from google.protobuf import descriptor as _d

    FD = _d.FieldDescriptor
    t = field.type
    if t in (FD.TYPE_INT32, FD.TYPE_INT64, FD.TYPE_UINT32, FD.TYPE_UINT64,
             FD.TYPE_SINT32, FD.TYPE_SINT64, FD.TYPE_FIXED32,
             FD.TYPE_FIXED64, FD.TYPE_SFIXED32, FD.TYPE_SFIXED64,
             FD.TYPE_ENUM):
        return FieldKind.INT
    if t in (FD.TYPE_FLOAT, FD.TYPE_DOUBLE):
        return FieldKind.FLOAT
    if t in (FD.TYPE_STRING, FD.TYPE_BYTES):
        return FieldKind.BYTES
    if t == FD.TYPE_BOOL:
        return FieldKind.BOOL
    raise UnsupportedFieldError(
        f"field {field.full_name!r} type {t} unsupported"
    )


def schema_from_descriptor(desc, prefix: str = "",
                           _depth: int = 0) -> Schema:
    """Flatten a protobuf message Descriptor into the columnar schema.

    Nested message fields recurse with dotted names; field order is the
    declaration order at every level (deterministic wire order)."""
    from google.protobuf import descriptor as _d

    if _depth > 16:
        raise UnsupportedFieldError("message nesting too deep")
    fields: list[tuple[str, FieldKind]] = []
    real = _real_oneofs(desc)
    oneofs = {f.name for o in real for f in o.fields}
    for o in real:
        # one opaque column per oneof group: only the SET branch
        # serializes, so which-branch state survives the round trip
        fields.append((prefix + "__oneof__." + o.name, FieldKind.BYTES))
    optionals = _optional_fields(desc)
    for field in desc.fields:
        if field.name in oneofs:
            continue
        name = prefix + field.name
        if field.is_repeated:
            fields.append((name, FieldKind.BYTES))  # opaque wire bytes
        elif field.type == _d.FieldDescriptor.TYPE_MESSAGE:
            sub = schema_from_descriptor(field.message_type, name + ".",
                                         _depth + 1)
            fields.extend(sub.fields)
        else:
            fields.append((name, _kind_for(field)))
            if field.name in optionals:
                fields.append((name + "@set", FieldKind.BOOL))
    return Schema(tuple(fields))


def _field_wire_bytes(m, field) -> bytes:
    """Serialize ONE field's state to proto wire bytes (tag included)
    by copying it into an empty sibling message — deterministic map
    ordering so equal states produce equal bytes."""
    tmp = type(m)()
    src = getattr(m, field.name)
    dst = getattr(tmp, field.name)
    if field.message_type is not None and field.message_type.GetOptions(
    ).map_entry:
        # map field; message-valued maps forbid update()/assignment
        vf = field.message_type.fields_by_name["value"]
        if vf.type == vf.TYPE_MESSAGE:
            for k in src:
                dst[k].CopyFrom(src[k])
        else:
            dst.update(src)
    elif field.is_repeated:
        if field.type == field.TYPE_MESSAGE:
            dst.MergeFrom(src)
        else:
            dst.extend(src)
    elif field.type == field.TYPE_MESSAGE:
        dst.CopyFrom(src)
    else:
        setattr(tmp, field.name, src)
    return tmp.SerializePartialToString(deterministic=True)


def message_to_columns(msg) -> dict:
    """Flatten one parsed protobuf message to {dotted name: value}
    (schema order supplies defaults for unset scalar fields)."""
    from google.protobuf import descriptor as _d

    out: dict = {}

    def walk(m, prefix: str):
        real = _real_oneofs(m.DESCRIPTOR)
        oneofs = {f.name for o in real for f in o.fields}
        for o in real:
            set_field = m.WhichOneof(o.name)
            out[prefix + "__oneof__." + o.name] = (
                b"" if set_field is None
                else _field_wire_bytes(m, m.DESCRIPTOR.fields_by_name[set_field]))
        optionals = _optional_fields(m.DESCRIPTOR)
        for field in m.DESCRIPTOR.fields:
            if field.name in oneofs:
                continue
            name = prefix + field.name
            if field.is_repeated:
                out[name] = _field_wire_bytes(m, field)
            elif field.type == _d.FieldDescriptor.TYPE_MESSAGE:
                walk(getattr(m, field.name), name + ".")
            else:
                v = getattr(m, field.name)
                if field.type == _d.FieldDescriptor.TYPE_STRING:
                    v = v.encode()
                elif field.type in (_d.FieldDescriptor.TYPE_FLOAT,
                                    _d.FieldDescriptor.TYPE_DOUBLE):
                    v = float(v)
                out[name] = v
                if field.name in optionals:
                    out[name + "@set"] = m.HasField(field.name)

    walk(msg, "")
    return out


def columns_to_message(msg, columns: dict):
    """Fill a protobuf message instance from flattened columns; returns
    the message (strings decode back from bytes)."""
    from google.protobuf import descriptor as _d

    def walk(m, prefix: str):
        real = _real_oneofs(m.DESCRIPTOR)
        oneofs = {f.name for o in real for f in o.fields}
        for o in real:
            blob = columns.get(prefix + "__oneof__." + o.name)
            if blob:
                m.MergeFromString(blob)
        optionals = _optional_fields(m.DESCRIPTOR)
        for field in m.DESCRIPTOR.fields:
            if field.name in oneofs:
                continue
            name = prefix + field.name
            if field.is_repeated:
                blob = columns.get(name)
                if blob:
                    m.MergeFromString(blob)
                continue
            if field.type == _d.FieldDescriptor.TYPE_MESSAGE:
                walk(getattr(m, field.name), name + ".")
                continue
            if field.name in optionals and not columns.get(name + "@set"):
                continue  # unset `optional` stays unset
            v = columns.get(name)
            if v is None:
                continue
            if field.type == _d.FieldDescriptor.TYPE_STRING:
                v = v.decode() if isinstance(v, bytes) else v
            elif field.type == _d.FieldDescriptor.TYPE_BOOL:
                v = bool(v)
            elif field.type in (_d.FieldDescriptor.TYPE_FLOAT,
                                _d.FieldDescriptor.TYPE_DOUBLE):
                v = float(v)
            else:
                v = int(v)
            setattr(m, field.name, v)

    walk(msg, "")
    return msg


# ---------------------------------------------------------------------------
# Schema annotation: serialized FileDescriptorSet + message name — the
# wire form the reference stores so decoders can rebuild the schema.
# ---------------------------------------------------------------------------

_SCHEMA_MAGIC = b"m3ps"


def pack_schema_annotation(file_descriptor_set_bytes: bytes,
                           message_name: str) -> bytes:
    name = message_name.encode()
    return (_SCHEMA_MAGIC + struct.pack("<H", len(name)) + name
            + file_descriptor_set_bytes)


def unpack_schema_annotation(raw: bytes):
    """(FileDescriptorSet bytes, message name) or None when `raw` is
    not a schema annotation."""
    if not raw.startswith(_SCHEMA_MAGIC):
        return None
    (n,) = struct.unpack_from("<H", raw, 4)
    name = raw[6 : 6 + n].decode()
    return raw[6 + n :], name


def descriptor_from_annotation(raw: bytes):
    """Rebuild the message Descriptor from a schema annotation through a
    fresh descriptor pool (the decode-side path: a node that has never
    seen this schema learns it from the stream)."""
    from google.protobuf import descriptor_pb2, descriptor_pool

    unpacked = unpack_schema_annotation(raw)
    if unpacked is None:
        raise ValueError("not a schema annotation")
    fds_bytes, message_name = unpacked
    fds = descriptor_pb2.FileDescriptorSet()
    fds.MergeFromString(fds_bytes)
    pool = descriptor_pool.DescriptorPool()
    for f in fds.file:
        pool.Add(f)
    return pool.FindMessageTypeByName(message_name)


def message_class_for(desc):
    """A concrete message class for a Descriptor (decode-side
    materialization)."""
    from google.protobuf import message_factory

    return message_factory.GetMessageClass(desc)
