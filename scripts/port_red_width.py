"""Scalar against vector float32 reductions into L2, on one CUDA card.

    python3 scripts/port_red_width.py

Asks whether the card's L2 atomic units are limited by operations or by
bytes. The same work, adding rows of 32 floats (128 bytes: the deformable
backward's dv row at dh = 32) into a 5.12 MB float32 buffer (one 200x200x32
value map's gradient, which stays in L2), is done four ways: with scalar
reductions (one float each), v2 (two floats) and v4 (four floats), that is
`atomicAdd` on a float, a float2 and a float4 whose result is unused, which
the compiler emits as RED; and v4 once more, each thread adding 8 floats in
two instructions, so that every instruction half fills each 32-byte sector
it touches (a bf16 lane of the deformable backward before its lanes traded
values). Two patterns of rows: drawn at random (the backward at uniform
locations) and in order. If the time falls with the width, operations limit
the units; if it stays, bytes do; if half-filled sectors cost as much as
full ones, sectors do.

Prints one JSON line per (pattern, width): ms (CUDA events, mean of 20
calls after 3 warm-up calls), reductions/s and payload bytes/s, then the
card's name and power limit. Builds its kernel with nvcc into
`build/probe/` (`lss2_multimodal_nu_tpu_torch/ops/_build.py`'s flags).
Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>

template <int W>
__global__ void red_rows(float* buf, const int* rows, long n_adds, int dh) {
  const int per_row = dh / W;
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (t >= n_adds * per_row) return;
  float* p = buf + (size_t)rows[t / per_row] * dh + (t % per_row) * W;
  const float x = 1e-3f * (float)(t & 7);
  if constexpr (W == 1) atomicAdd(p, x);
  if constexpr (W == 2) atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, x));
  if constexpr (W == 4) atomicAdd(reinterpret_cast<float4*>(p), make_float4(x, x, x, x));
}

// Width 4 in two instructions per thread: floats 8t .. 8t+3, then 8t+4 ..
// 8t+7, so that each instruction fills half of every 32-byte sector it touches.
__global__ void red_rows_half(float* buf, const int* rows, long n_adds, int dh) {
  const int per_row = dh / 8;
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (t >= n_adds * per_row) return;
  float* p = buf + (size_t)rows[t / per_row] * dh + (t % per_row) * 8;
  const float x = 1e-3f * (float)(t & 7);
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(x, x, x, x));
  atomicAdd(reinterpret_cast<float4*>(p + 4), make_float4(x, x, x, x));
}

extern "C" int red_rows_launch(int width, void* buf, const void* rows, long n_adds, int dh,
                               void* stream) {
  const long threads = n_adds * (dh / (width == 0 ? 8 : width));
  const dim3 grid((unsigned)((threads + 255) / 256));
  cudaStream_t s = (cudaStream_t)stream;
  const int* r = (const int*)rows;
  float* b = (float*)buf;
  if (width == 1) red_rows<1><<<grid, 256, 0, s>>>(b, r, n_adds, dh);
  else if (width == 2) red_rows<2><<<grid, 256, 0, s>>>(b, r, n_adds, dh);
  else if (width == 4) red_rows<4><<<grid, 256, 0, s>>>(b, r, n_adds, dh);
  else if (width == 0) red_rows_half<<<grid, 256, 0, s>>>(b, r, n_adds, dh);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""

ROWS, DH = 40000, 32       # one 200x200 map of 32 float32 channels: 5.12 MB
N_ADDS = 1 << 22           # row additions a call: 4.19 M x 128 B = 537 MB of payload


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from lss2_multimodal_nu_tpu_torch.ops import _build

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "red_width.cu", out / "libred_width.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.red_rows_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    so.red_rows_launch.restype = ctypes.c_int
    return so


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_red_width: needs a CUDA card", file=sys.stderr)
        return 1
    so = build()
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    buf = torch.zeros(ROWS * DH, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    patterns = {
        "random": rng.integers(0, ROWS, N_ADDS).astype(np.int32),
        "in_order": (np.arange(N_ADDS) % ROWS).astype(np.int32),
    }
    for pattern, rows in patterns.items():
        rows = torch.from_numpy(rows).to(dev)
        for width in (1, 2, 4, 0):
            def call():
                code = so.red_rows_launch(width, buf.data_ptr(), rows.data_ptr(), N_ADDS, DH,
                                          stream)
                if code:
                    raise RuntimeError(f"launch failed: error {code}")

            for _ in range(3):
                call()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(20):
                call()
            e.record()
            e.synchronize()
            ms = s.elapsed_time(e) / 20
            ops = N_ADDS * DH // (width or 4)
            print(json.dumps(dict(pattern=pattern, width=width or "4, half sectors", ms=ms,
                                  reductions=ops,
                                  reductions_per_s=ops / ms * 1e3,
                                  payload_bytes_per_s=N_ADDS * DH * 4 / ms * 1e3)))
    if not bool(torch.isfinite(buf).all()):
        print("port_red_width: non-finite sums", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
