"""CLI: generate a benchmark input mesh.

Copy of ``membrane_solver_tpu/meshgen/__main__.py`` (NumPy host code); only the
import paths differ.

    python -m membrane_solver_tpu_torch.meshgen kozlov_1disk -o lane.json
    python -m membrane_solver_tpu_torch.meshgen --list
    python -m membrane_solver_tpu_torch.meshgen catenoid --set n_theta=24 -o c.json
"""

from __future__ import annotations

import argparse
import json
import sys

from membrane_solver_tpu_torch.meshgen.builders import BUILDERS, build


def _parse_kv(pairs):
    out = {}
    for p in pairs or []:
        key, _, raw = p.partition("=")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="membrane_solver_tpu_torch.meshgen")
    ap.add_argument("name", nargs="?", help="builder name")
    ap.add_argument("-o", "--output", default=None, help="output path (default stdout)")
    ap.add_argument("--set", action="append", dest="params", metavar="K=V",
                    help="builder kwarg, JSON-valued (repeatable)")
    ap.add_argument("--list", action="store_true", help="list builders")
    args = ap.parse_args(argv)

    if args.list or not args.name:
        for name in sorted(BUILDERS):
            print(name)
        return 0

    data = build(args.name, **_parse_kv(args.params))
    text = json.dumps(data, indent=1)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"Wrote {args.output}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
