"""Validate trace files from the command line (the CI smoke step):

    python -m repro_torch.trace out.json [more.json ...]

Exit 0 when every file is schema-valid Chrome-trace JSON, 1 otherwise,
listing each violation.
"""
from __future__ import annotations

import sys

from .schema import validate_file


def main(argv=None) -> int:
    paths = list(sys.argv[1:] if argv is None else argv)
    if not paths:
        print("usage: python -m repro_torch.trace <trace.json> [...]",
              file=sys.stderr)
        return 2
    bad = 0
    for p in paths:
        errors = validate_file(p)
        if errors:
            bad += 1
            print(f"{p}: INVALID")
            for e in errors:
                print(f"  {e}")
        else:
            print(f"{p}: ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
