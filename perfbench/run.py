"""The benchmark of the search stage of svdss_tpu_torch on one card.

    python3 -m perfbench.run --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (and ``breakdown`` when traced), and last
``checks``: each number that decides ``correct`` with its limit. The same
numbers end standard error. Exits non-zero, printing no result, without
CUDA or with fewer cards than the cell asks for, when the program cannot
be imported, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    import torch
    from .spec import load_cell
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available():
        return fail(2, "CUDA is not available: no result")
    if torch.cuda.device_count() < cell.chips:
        return fail(2, f"the cell asks for {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found: no result")
    try:
        import svdss_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(3, f"the program is not in this checkout ({exc}): "
                    "no result")
    from . import harness
    out, lines = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(4, "modules the port may not load were loaded: "
                    + ", ".join(bad) + ": no result")
    for line in lines:
        print(f"[perfbench] {line}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
