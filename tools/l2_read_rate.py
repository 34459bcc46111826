"""Read rate of the card's L2, the rate behind ``chip_smoke.py``'s
``L2_BYTES_PER_S`` (the ``table_sums`` bound: its table rows stay in L2).

One kernel streams a device buffer with 16-byte loads that skip L1
(``ld.global.cg``, ``__ldcg``), a grid-stride pass at a time, for buffers
small enough to stay in L2 (the H100's is 50 MB) and for one of 4 GB that
does not (HBM). Each size is timed by CUDA events over ``--reps``
launches, after one launch that warms it; the best of ``--rounds`` rounds
is printed, in TB/s (1e12 B/s) of bytes loaded.

    python tools/l2_read_rate.py [--sizes-mb 4 8 16 24 32 4096]

Needs a CUDA card and nvcc (``$CUDA_HOME/bin/nvcc``, by default
``/usr/local/cuda``). The kernel is built into a temporary directory that
is removed on exit. Prints one line a size, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
from pathlib import Path

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(512)
l2_read(const int4* __restrict__ buf, long n, int passes, int* out) {
  int acc = 0;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 4
    for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      const int4 v = __ldcg(buf + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x7fffffff) out[0] = acc;   // keeps every load live
}

extern "C" int l2_read_launch(const void* buf, long n, int passes, void* out,
                              int blocks, void* stream) {
  l2_read<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buf), n, passes, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def _build(tmp: Path) -> ctypes.CDLL:
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    (tmp / "l2.cu").write_text(SOURCE)
    subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(tmp / "l2.so"), str(tmp / "l2.cu")], check=True)
    lib = ctypes.CDLL(str(tmp / "l2.so"))
    lib.l2_read_launch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p]
    return lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes-mb", type=int, nargs="+",
                    default=[4, 8, 16, 24, 32, 4096])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    dev = torch.device("cuda", 0)
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build(Path(tmp))
        for mb in args.sizes_mb:
            nbytes = mb << 20
            buf = torch.ones(nbytes // 4, dtype=torch.int32, device=dev)
            n = nbytes // 16
            passes = max(1, (2 << 30) // nbytes)    # ~2 GiB loaded a launch

            def launch():
                rc = lib.l2_read_launch(buf.data_ptr(), n, passes,
                                        out.data_ptr(), blocks, stream)
                if rc:
                    raise RuntimeError(f"l2_read launch failed: {rc}")

            launch()
            best = 0.0
            for _ in range(args.rounds):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(args.reps):
                    launch()
                e1.record()
                torch.cuda.synchronize(dev)
                s = e0.elapsed_time(e1) / 1e3
                best = max(best, nbytes * passes * args.reps / s / 1e12)
            rates[mb] = best
            print(f"[l2read] {mb} MB x {passes} passes, ld.global.cg 16 B: "
                  f"best {best:.3f} TB/s", flush=True)
            del buf
    print(json.dumps({"card": torch.cuda.get_device_name(dev),
                      "tb_per_s": rates}), flush=True)


if __name__ == "__main__":
    main()
