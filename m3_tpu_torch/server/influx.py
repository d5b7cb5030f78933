"""InfluxDB line-protocol ingest.
The port's copy of ``m3_tpu/server/influx.py`` (it imports nothing of ``m3_tpu``).

Equivalent of `src/query/api/v1/handler/influxdb/write.go`: parse the
line protocol (measurement,tags fields timestamp), emit one series per
(measurement, field) pair named ``measurement_field`` with the point's
tags (the reference's ingestIterator promotes each field to __name__
the same way, write.go:73,142-181), and feed the standard tagged-write
path.  Value handling follows the reference: floats and ints ingest as
float64, booleans as 1/0, string fields are skipped.

Line protocol grammar handled here: backslash-escaped characters in
identifiers, double-quoted string field values with escapes, integer suffix ``i``, and the s/ms/us/ns timestamp precisions
of the ?precision= query parameter.
"""

from __future__ import annotations

from dataclasses import dataclass

PRECISION_NANOS = {"h": 3600 * 10**9, "m": 60 * 10**9, "s": 10**9,
                   "ms": 10**6, "us": 10**3, "u": 10**3, "ns": 1, "n": 1}


class LineProtocolError(ValueError):
    pass


@dataclass(frozen=True)
class InfluxPoint:
    measurement: bytes
    tags: tuple  # ((name, value) bytes pairs, sorted)
    fields: tuple  # ((name, float value) pairs; strings dropped)
    timestamp_nanos: int


def _scan_sections(line: str) -> tuple[str, str, str]:
    """(measurement+tags, fields, timestamp) honoring escapes and quoted
    field strings: sections split on unescaped spaces outside quotes."""
    sections = []
    cur = []
    in_quote = False
    i = 0
    while i < len(line):
        c = line[i]
        if c == "\\" and i + 1 < len(line):
            cur.append(line[i : i + 2])
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
            cur.append(c)
        elif c == " " and not in_quote:
            if cur:
                sections.append("".join(cur))
                cur = []
            if len(sections) == 2:
                # rest is the timestamp
                rest = line[i + 1 :].strip()
                return sections[0], sections[1], rest
        else:
            cur.append(c)
        i += 1
    if in_quote:
        raise LineProtocolError("unterminated string field")
    if cur:
        sections.append("".join(cur))
    if len(sections) < 2:
        raise LineProtocolError(f"missing fields in line {line!r}")
    while len(sections) < 3:
        sections.append("")
    return sections[0], sections[1], sections[2]


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _parse_key(section: str):
    """measurement[,tag=value...] with escape handling."""
    parts = []
    cur = []
    i = 0
    while i < len(section):
        c = section[i]
        if c == "\\" and i + 1 < len(section):
            cur.append(section[i : i + 2])
            i += 2
            continue
        if c == ",":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    measurement = _unescape(parts[0])
    if not measurement:
        raise LineProtocolError("empty measurement")
    tags = []
    for p in parts[1:]:
        eq = -1
        j = 0
        while j < len(p):
            if p[j] == "\\":
                j += 2
                continue
            if p[j] == "=":
                eq = j
                break
            j += 1
        if eq < 0:
            raise LineProtocolError(f"bad tag {p!r}")
        tags.append((_unescape(p[:eq]).encode(), _unescape(p[eq + 1 :]).encode()))
    return measurement.encode(), tuple(sorted(tags))


def _parse_fields(section: str):
    """field=value[,field=value...]; strings dropped, bools -> 1/0,
    trailing-i ints -> float (the reference ingests ints as float64)."""
    fields = []
    cur = []
    in_quote = False
    parts = []
    i = 0
    while i < len(section):
        c = section[i]
        if c == "\\" and i + 1 < len(section):
            cur.append(section[i : i + 2])
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
            cur.append(c)
        elif c == "," and not in_quote:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    for p in parts:
        if not p:
            continue
        # first UNESCAPED '=' splits key from value ('\=' is legal in
        # field keys, same scan as the tag parser)
        eq = -1
        j = 0
        while j < len(p):
            if p[j] == "\\":
                j += 2
                continue
            if p[j] == "=":
                eq = j
                break
            j += 1
        if eq < 0:
            raise LineProtocolError(f"bad field {p!r}")
        name = _unescape(p[:eq]).encode()
        raw = p[eq + 1 :]
        if raw.startswith('"'):
            continue  # string field: skipped (reference write.go:142)
        if raw in ("t", "T", "true", "True", "TRUE"):
            fields.append((name, 1.0))
        elif raw in ("f", "F", "false", "False", "FALSE"):
            fields.append((name, 0.0))
        else:
            if raw.endswith(("i", "u")):
                raw = raw[:-1]
            try:
                fields.append((name, float(raw)))
            except ValueError:
                raise LineProtocolError(f"bad field value {p!r}") from None
    return tuple(fields)


def parse_lines(body: str, precision: str = "ns",
                now_nanos: int | None = None) -> list[InfluxPoint]:
    mult = PRECISION_NANOS.get(precision)
    if mult is None:
        raise LineProtocolError(f"bad precision {precision!r}")
    points = []
    for raw_line in body.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        key, fields_s, ts_s = _scan_sections(line)
        measurement, tags = _parse_key(key)
        fields = _parse_fields(fields_s)
        if ts_s:
            try:
                ts = int(ts_s) * mult
            except ValueError:
                raise LineProtocolError(f"bad timestamp {ts_s!r}") from None
        else:
            if now_nanos is None:
                raise LineProtocolError("missing timestamp")
            ts = now_nanos
        points.append(InfluxPoint(measurement, tags, fields, ts))
    return points


def points_to_writes(points: list[InfluxPoint]):
    """Flatten to the tagged-write arrays: one series per (measurement,
    field), named measurement_field (reference write.go name promotion).

    Returns (docs, ts (int64 list), values (float list))."""
    from m3_tpu_torch.index.doc import Document

    docs, ts, vals = [], [], []
    for p in points:
        for fname, fval in p.fields:
            name = p.measurement + b"_" + fname if fname != b"value" else p.measurement
            # promoted name wins over any literal __name__ point tag so
            # the document's name and its series id always agree
            tags = {**dict(p.tags), b"__name__": name}
            sid = name + b"{" + b",".join(
                k + b"=" + v for k, v in sorted(p.tags)) + b"}"
            docs.append(Document.from_tags(sid, tags))
            ts.append(p.timestamp_nanos)
            vals.append(fval)
    return docs, ts, vals
