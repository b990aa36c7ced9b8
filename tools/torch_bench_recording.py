"""One benchmark run with the port's span recording on and no profiler:
``benchmark/run.py``'s command inside
``zpix_tpu_torch.utils.profiling.recording()``, so that its end-to-end
metrics, against ``benchmark/run.py``'s own run of the same cell and seed
(interleaved, on one card), give what recording costs.

    python3 tools/torch_bench_recording.py --workload qoi.screen --seed 2147502601 \\
        --seconds 51 --trace 0

It prints the benchmark's result line, and on standard error how many
spans were kept and dropped.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402  (its import is the run's start, as the benchmark's own)


def main() -> int:
    sys.pycache_prefix, sys.dont_write_bytecode = run.PYCACHE, False
    from zpix_tpu_torch.utils import profiling

    with profiling.recording():
        code = run.main(sys.argv[1:])
    print(f"recording: {len(profiling.spans())} spans kept, "
          f"{profiling.metrics.spans_dropped} dropped", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
