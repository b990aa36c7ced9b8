"""The benchmark's command: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: it decodes the cell's corpus through
zpix_tpu_torch on the card (see ``harness.py``) and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks`` (each number compared, with its limit; also the last
lines of standard error).  With no CUDA card, fewer cards than the cell
asks for, or JAX or zpix_tpu loaded once the window has closed, it exits
with a code other than 0 and prints no result.
"""

import time

T_START = time.perf_counter()  # the process's start, before any heavy import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's bytecode, torch's included, is kept in the checkout at a fixed
# path: where the environment writes none (PYTHONDONTWRITEBYTECODE) and the
# installed packages carry none, every run would compile torch's sources
# anew, some seconds of set-up; so only a checkout's first run compiles.
PYCACHE = os.path.join(ROOT, "benchmark", ".cache", "pyc")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 3
    result = harness.measure(args.workload, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device=torch.device("cuda", 0),
                             t_start=T_START,
                             log=lambda line: print(line, file=sys.stderr, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
