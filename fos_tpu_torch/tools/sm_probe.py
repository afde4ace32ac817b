"""Two calibrations of one SM of the card that bound the tile lane kernels
(``csrc/tile_mv.cu``'s ``tile_mv_lanes``): the FMA rate of their
consumers' register block with its operands in registers, and the
shared-memory time of a warp's 16-byte loads under three address patterns.

    python3 -m fos_tpu_torch.tools.sm_probe [--out FILE]

Needs the card.  The probe kernels are built from the source below with
``_cuda.build_library`` into ``build/`` (one nvcc call).  Lines printed
(also appended to ``--out``), each counted on the SMs' own clocks
(``clock64`` around a block's loop, after a barrier):

* ``ffma``: per register block (rows x lanes x float4 columns a thread,
  256 threads, one block an SM, 2400 passes of its FMAs), the FMAs an SM
  issued a clock (128 is the f32 peak) and the TFLOP/s of the whole card;
* ``lds``: per pattern, the SM clocks one warp's ``LDS.128`` takes with 8
  warps an SM issuing them: ``distinct`` (each thread its own 16 bytes),
  ``groups_of_8`` (4 groups of 8 threads each read the same 128 bytes:
  how a lane kernel's row sets read one lane's x window), ``one_address``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from fos_tpu_torch.linalg import _cuda
from fos_tpu_torch.tools.k1_ab import emit

SOURCE = r"""
#include <cuda_runtime.h>

// kR rows x kL lanes at kC float4 columns: kC kL kR 4 FMAs a pass, each
// accumulator a chain of 4 (x, y, z, w) a column, as tile_mv_lanes'.
template <int kR, int kL, int kC>
__global__ void __launch_bounds__(256, 1)
ffma(const float4* src, int passes, float* out, long long* clocks) {
  float4 a[kR], x[kL];
  for (int i = 0; i < kR; ++i) a[i] = src[(threadIdx.x + i) & 63];
  for (int j = 0; j < kL; ++j) x[j] = src[(threadIdx.x * 3 + j) & 63];
  float acc[kC * kL * kR];
#pragma unroll
  for (int q = 0; q < kC * kL * kR; ++q) acc[q] = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int g = 0; g < kC; ++g) {
#pragma unroll
      for (int j = 0; j < kL; ++j)
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          float& v = acc[(g * kL + j) * kR + i];
          v = fmaf(a[i].x, x[j].x, v);
          v = fmaf(a[i].y, x[j].y, v);
          v = fmaf(a[i].z, x[j].z, v);
          v = fmaf(a[i].w, x[j].w, v);
        }
      // a new operand each column, so no pass can be hoisted
      a[g % kR] = make_float4(a[g % kR].y, a[g % kR].z, a[g % kR].w,
                              a[g % kR].x);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) clocks[blockIdx.x] = clock64() - t0;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kC * kL * kR; ++q) s += acc[q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 32 LDS.128 a pass a warp.  kPattern 0: thread t reads float4 t (512
// distinct bytes a warp); 1: float4 t % 8 (4 groups of 8 threads on the
// same 128 bytes); 2: all the same float4.
template <int kPattern>
__global__ void __launch_bounds__(256, 1)
lds(int passes, float* out, long long* clocks) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += 256)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int off = kPattern == 0 ? lane : kPattern == 1 ? (lane & 7) : 0;
  float4 s = make_float4(0, 0, 0, 0);
  int base = (threadIdx.x >> 5) * 64;
  const long long t0 = clock64();
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float4 v = buf[(base + u * 32 + off) & 2047];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    base = (base + 7) & 1023;
  }
  __syncthreads();
  if (threadIdx.x == 0) clocks[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = s.x + s.y + s.z + s.w;
}

extern "C" int sm_probe(int which, int blocks, int passes, const float* src,
                        float* out, long long* clocks) {
  auto s4 = reinterpret_cast<const float4*>(src);
  switch (which) {
    case 0: ffma<8, 8, 2><<<blocks, 256>>>(s4, passes, out, clocks); break;
    case 1: ffma<4, 8, 4><<<blocks, 256>>>(s4, passes, out, clocks); break;
    case 10: lds<0><<<blocks, 256>>>(passes, out, clocks); break;
    case 11: lds<1><<<blocks, 256>>>(passes, out, clocks); break;
    case 12: lds<2><<<blocks, 256>>>(passes, out, clocks); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
"""

#: (which, rows, lanes, columns) of the register blocks probed: the lane
#: kernel's (8 x 8 at 2 columns) and the 4 x 8 at 4 it was measured against
FFMA = ((0, 8, 8, 2), (1, 4, 8, 4))
LDS = ((10, "distinct"), (11, "groups_of_8"), (12, "one_address"))
FFMA_PASSES, LDS_PASSES = 2400, 2000


def library():
    src = _cuda.BUILD_DIR / "sm_probe" / "sm_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    out = src.with_name("libsm_probe.so")
    _cuda.build_library(out, [src])
    lib = ctypes.CDLL(str(out))
    lib.sm_probe.restype = ctypes.c_int
    lib.sm_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    return lib


def run(lib, which, blocks, passes, src, out, clocks):
    """The median over the blocks of their loop's SM clocks, and the
    run's wall time (s) from CUDA events (the second of two runs)."""
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.sm_probe(which, blocks, passes, src.data_ptr(),
                          out.data_ptr(), clocks.data_ptr())
        end.record()
        if rc:
            raise RuntimeError(f"sm_probe {which}: CUDA error {rc}")
        end.synchronize()
    return float(clocks.double().median()), start.elapsed_time(end) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/sm_probe.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sm_probe: no CUDA device")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card}, args.out)
    lib = library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = torch.randn(256, device=dev)
    out = torch.empty(sms * 256, device=dev)
    clocks = torch.zeros(sms, dtype=torch.int64, device=dev)
    for which, rows, lanes, cols in FFMA:
        cyc, wall = run(lib, which, sms, FFMA_PASSES, src, out, clocks)
        fmas = 256 * FFMA_PASSES * cols * lanes * rows * 4
        emit({"what": "ffma", "rows": rows, "lanes": lanes, "columns": cols,
              "fma_per_sm_clock": fmas / cyc,
              "tflops": 2 * fmas * sms / wall / 1e12}, args.out)
    for which, name in LDS:
        cyc, _ = run(lib, which, sms, LDS_PASSES, src, out, clocks)
        emit({"what": "lds", "pattern": name,
              "sm_clocks_per_warp_lds128": cyc / (8 * LDS_PASSES * 32)},
             args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
