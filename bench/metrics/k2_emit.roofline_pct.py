"""K2 (``kernels/csrc/hamming.cu`` ``dist_kernel``) in the dense join's
emission tiles against its roofline: the least time the profiled jobs'
tiles need (``bench/roofline_hamming.py``, from the program's counts of
tiles and of their query rows, ``emit_tiles`` and ``emit_rows``, each
tile against every reference) over K2's device time there (%)."""
import re
from pathlib import Path

from bench.harness import load_module
from bench.readers import kernel_s
from bench.roofline_hamming import hamming_dist_bound_s

K2 = re.compile(r"(?<![A-Za-z0-9_])dist(_wide)?_kernel(?![A-Za-z0-9_])")


def read(ctx):
    k2 = kernel_s(ctx, lambda name: K2.search(name) is not None)
    k6 = load_module("metrics", "k6_count.roofline_pct",
                     Path(__file__).resolve().parents[1])
    jobs = k6.profiled_jobs(ctx) if k2 > 0 else None
    if not jobs or any(j.get("emit_rows") is None for _, j in jobs):
        return None
    R, nw = k6.shapes(ctx)
    bound = sum(hamming_dist_bound_s(j["emit_rows"], R, nw,
                                     j["emit_tiles"])[0]
                for _, j in jobs if j["emit_tiles"])
    return 100.0 * bound / k2
