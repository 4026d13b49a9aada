"""Influx line-protocol encoder: the port's copy of
``tensorfusion_tpu/metrics/encoder.py``, for the hypervisor's view of a
worker's serving engine (``hypervisor/metrics.py``) and of its profiler
(``profiling/export.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from ..clock import default_clock

Value = Union[int, float, str, bool]


def _escape_tag(s: str) -> str:
    return (str(s).replace("\\", "\\\\").replace(",", "\\,")
            .replace(" ", "\\ ").replace("=", "\\="))


def _field_value(v: Value) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return f"{v}i"
    if isinstance(v, float):
        return repr(float(v))
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'


def encode_line(measurement: str, tags: Dict[str, str],
                fields: Dict[str, Value],
                ts_ns: Optional[int] = None) -> str:
    if not fields:
        raise ValueError("at least one field required")
    parts = [_escape_tag(measurement)]
    for k in sorted(tags):
        parts.append(f"{_escape_tag(k)}={_escape_tag(tags[k])}")
    head = ",".join(parts)
    body = ",".join(f"{_escape_tag(k)}={_field_value(v)}"
                    for k, v in sorted(fields.items()))
    if ts_ns is None:
        ts_ns = default_clock().now_ns()
    return f"{head} {body} {ts_ns}"


def parse_line(line: str):
    """Minimal inverse of encode_line (used by the TSDB ingester).
    Returns (measurement, tags, fields, ts_ns)."""
    line = line.strip()
    # head ends at the first space that is neither escaped nor quoted
    # (the head never contains quotes).
    esc = False
    head_end = -1
    for i, ch in enumerate(line):
        if esc:
            esc = False
        elif ch == "\\":
            esc = True
        elif ch == " ":
            head_end = i
            break
    if head_end < 0:
        raise ValueError(f"invalid line: {line!r}")
    head, rest = line[:head_end], line[head_end + 1:]
    # fields/timestamp split on the last space OUTSIDE quoted strings.
    esc, quoted, last_space = False, False, -1
    for i, ch in enumerate(rest):
        if esc:
            esc = False
        elif ch == "\\":
            esc = True
        elif ch == '"':
            quoted = not quoted
        elif ch == " " and not quoted:
            last_space = i
    if last_space >= 0 and rest[last_space + 1:].lstrip("-").isdigit():
        fieldstr, ts_ns = rest[:last_space], int(rest[last_space + 1:])
    else:
        fieldstr, ts_ns = rest, default_clock().now_ns()

    def unescape(s: str) -> str:
        out, esc = [], False
        for ch in s:
            if esc:
                out.append(ch)
                esc = False
            elif ch == "\\":
                esc = True
            else:
                out.append(ch)
        return "".join(out)

    def split_unescaped(s: str, sep: str, respect_quotes: bool = False):
        parts, cur, esc, quoted = [], [], False, False
        for ch in s:
            if esc:
                cur.append(ch)
                esc = False
            elif ch == "\\":
                cur.append(ch)
                esc = True
            elif respect_quotes and ch == '"':
                cur.append(ch)
                quoted = not quoted
            elif ch == sep and not quoted:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        parts.append("".join(cur))
        return parts

    def partition_unescaped(s: str):
        esc = False
        for i, ch in enumerate(s):
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == "=":
                return s[:i], s[i + 1:]
        return s, ""

    head_parts = split_unescaped(head, ",")
    measurement = unescape(head_parts[0])
    tags = {}
    for kv in head_parts[1:]:
        k, v = partition_unescaped(kv)
        tags[unescape(k)] = unescape(v)
    fields: Dict[str, Value] = {}
    for kv in split_unescaped(fieldstr, ",", respect_quotes=True):
        k, v = partition_unescaped(kv)
        k = unescape(k)
        if v.startswith('"'):
            fields[k] = v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        elif v.endswith("i"):
            fields[k] = int(v[:-1])
        elif v in ("true", "false"):
            fields[k] = v == "true"
        else:
            fields[k] = float(v)
    return measurement, tags, fields, ts_ns
