#!/usr/bin/env python3
"""Compare two ``chip_smoke.py`` logs field by field, leaving out what a clock measured.

Two trees run on one card (an older one unpacked with ``git archive``)
must agree on everything their runs decide: the ``[... determinism]``
digests, every error against the JAX fixtures and every float32
deviation, the launch counts, the kernels' ``max_abs_err``.  This reads
every ``[label] key=value ...`` line of both logs and the ``{"kernels":
[...]}`` line, drops the fields a clock or the host measured (seconds,
ms, µs, busy shares, rates, the allocator's peaks, the build's own lines
and the card's name and limit), and prints one JSON object: the fields compared, how many
are equal, and every field that differs or is in one log only.

Usage::

    python3 tools/compare_smoke_logs.py OLD.log NEW.log [--ignore REGEX ...]

``--ignore`` drops further keys (a regular expression on ``label.key``),
for a field one tree prints and the other does not.  Exit code 1 when a
field differs.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

LINE = re.compile(r"^\[([^\]]+)\] (.*)$")
FIELD = re.compile(r"(\w+)=((?:\"[^\"]*\"|'[^']*'|\[[^\]]*\]|\{[^}]*\}|\S)+)")
# keys a clock, the host or the build decides
CLOCKED = re.compile(r"(second|_s$|^s$|ms|_us$|us_|host|busy|share|per_s|event|window|time|"
                     r"card|torch|cuda|python|libraries|line$|^name$|smi|rate|speed|syncs|"
                     r"^phases$)")
# whole lines a clock decides
CLOCKED_LABEL = re.compile(r"(timing|busy|parts|phase seconds|^total$|build|sync sites|"
                           r"seconds|peak memory)")
# the kernels line: the keys a clock decides
KERNEL_CLOCKED = {"ms", "plain_ms", "library_ms", "event_ms", "host_us", "single_ms"}


def fields(path: Path) -> dict:
    out = {}
    for line in path.read_text(errors="replace").splitlines():
        if line.startswith('{"kernels":'):
            for k in json.loads(line)["kernels"]:
                for key, value in k.items():
                    if key not in KERNEL_CLOCKED:
                        out[f"kernels.{k['name']}.{key}"] = json.dumps(value)
            continue
        m = LINE.match(line)
        if not m or CLOCKED_LABEL.search(m.group(1)):
            continue
        label = m.group(1)
        for key, value in FIELD.findall(m.group(2)):
            if CLOCKED.search(key):
                continue
            name = f"{label}.{key}"
            while name in out or f"{name}.{{" in out:  # a label printed more than once
                name += "'"
            try:
                parsed = json.loads(value)
            except ValueError:
                parsed = None
            if isinstance(parsed, dict):  # a dict of counts: one field per key
                out[f"{name}.{{"] = "dict"
                for sub, v in parsed.items():
                    out[f"{name}.{sub}"] = json.dumps(v)
            else:
                out[name] = value
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--ignore", action="append", default=[],
                    help="a regular expression on label.key to leave out (repeatable)")
    args = ap.parse_args()
    ignore = [re.compile(r) for r in args.ignore]
    old, new = fields(args.old), fields(args.new)
    keys = sorted(k for k in set(old) | set(new) if not any(r.search(k) for r in ignore))
    differ = {k: [old.get(k), new.get(k)] for k in keys if old.get(k) != new.get(k)}
    print(json.dumps({"compared": len(keys), "equal": len(keys) - len(differ), "differ": differ},
                     indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
