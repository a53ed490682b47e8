"""Kernels 6 and 7 (`csrc/jpeg_idct.cu`, `csrc/img_aug.cu`) run on the CPU
from their CUDA sources, against their plain versions bit for bit.

Both sources are built with the host's g++ against a stub CUDA runtime
(`STUB`): the CTAs run one after another, each CUDA thread a coroutine
(ucontext) run in turns from one barrier to the next, `__syncthreads` and
`__syncwarp` alike (both kernels call them from every thread), cp.async as a memcpy, funnel shifts
and byte permutes in C, and each `<<<...>>>` launch as a call of the stub's
launcher. The C entry points are the ones the wrappers call, tiles and all.
Shared memory is filled with a new byte before every CTA, and the output and
the device scratch with random bytes, so a pixel that reads a sample its CTA
did not stage or decode differs from the plain version: what each CTA reads
(its strip and band of MCUs and their chroma halo, the source columns and
intermediate rows its windows span) is held here without a card. Races and
speed are not. The `bound` functions and the SASS count they take are held
on small inputs. Needs g++ with C++20; torch on one thread.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu_torch.config import AugConfig
from lss2_multimodal_nu_tpu_torch.core.augment import sample_augmentation
from lss2_multimodal_nu_tpu_torch.data import jpeg
from lss2_multimodal_nu_tpu_torch.ops import _build, img_aug, jpeg_idct

CSRC = Path(jpeg_idct.__file__).resolve().parent.parent / "csrc"
SMEM_BYTES = 232448  # a CTA's shared memory at most on sm_90

STUB = r'''#pragma once
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
#include <ucontext.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__ __restrict
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx;
inline unsigned char* g_smem = nullptr;
inline unsigned g_poison = 0;
inline ucontext_t g_main;
inline std::vector<ucontext_t> g_fiber;
inline std::function<void()> g_body;
inline void __syncthreads() { swapcontext(&g_fiber[threadIdx.x], &g_main); }
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
inline void emu_fiber() { g_body(); }
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
using std::min;
using std::max;
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return static_cast<unsigned>((((unsigned long long)hi << 32) | lo) >> (sh & 31));
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long pool = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= ((pool >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline int atomicMin(int* p, int v) {  // one CUDA thread runs at a time
  const int old = *p;
  *p = min(old, v);
  return old;
}
inline int atomicMax(int* p, int v) {
  const int old = *p;
  *p = max(old, v);
  return old;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess, cudaErrorInvalidValue, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int v) { return v > SMEM_BYTES; }
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int, void*, A... args) {
  constexpr size_t kStack = 1 << 17;
  std::vector<char> stacks(block.x * kStack);
  std::vector<char> done(block.x);
  g_fiber.assign(block.x, ucontext_t{});
  g_body = [&] { kernel(args...); done[threadIdx.x] = 1; };
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        g_poison = g_poison * 1103515245u + 12345u;
        std::memset(g_smem, static_cast<int>(g_poison >> 16) & 0xff, SMEM_BYTES);
        blockIdx = dim3(bx, by, bz);
        for (unsigned t = 0; t < block.x; ++t) {
          getcontext(&g_fiber[t]);
          g_fiber[t].uc_stack.ss_sp = stacks.data() + t * kStack;
          g_fiber[t].uc_stack.ss_size = kStack;
          g_fiber[t].uc_link = &g_main;
          makecontext(&g_fiber[t], emu_fiber, 0);
          done[t] = 0;
        }
        // a round runs every thread to its next barrier (or its end)
        for (bool left = true; left;) {
          left = false;
          for (unsigned t = 0; t < block.x; ++t) {
            if (done[t]) continue;
            threadIdx = dim3(t);
            swapcontext(&g_main, &g_fiber[t]);
            left = left || !done[t];
          }
        }
      }
}
'''.replace("SMEM_BYTES", str(SMEM_BYTES))

COMMON = r'''#pragma once
#include "cuda_runtime.h"
namespace lss {
inline void cp_async4(void* s, const void* g) { std::memcpy(s, g, 4); }
inline void cp_async16(void* s, const void* g) { std::memcpy(s, g, 16); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
}  // namespace lss
extern "C" const char* lss_error_string(int code) { return cudaGetErrorString(code); }
'''


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"jpeg_idct": C entry, "img_aug": C entry} built from the sources."""
    if shutil.which("g++") is None:
        pytest.skip("the kernels' CPU build needs g++")
    out = tmp_path_factory.mktemp("emulated_kernels")
    (out / "cuda_runtime.h").write_text(STUB)
    (out / "common.cuh").write_text(COMMON)
    procs = {}
    for name in ("jpeg_idct", "img_aug"):
        src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                     (CSRC / f"{name}.cu").read_text(), flags=re.S)
        cpp = out / f"{name}.cpp"
        cpp.write_text('#include "cuda_runtime.h"\n'
                       f"namespace {{ alignas(16) unsigned char smem[{SMEM_BYTES}]; "
                       "const bool smem_set = (g_smem = smem, true); }\n" + src)
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off", "-w",
             f"-I{out}", "-o", str(out / f"lib{name}.so"), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, symbol, argtypes in (("jpeg_idct", "jpeg_idct_decode", jpeg_idct._ARGTYPES),
                                   ("img_aug", "img_aug_forward", img_aug._ARGTYPES)):
        log, _ = procs[name].communicate()
        assert procs[name].returncode == 0, log
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield entries
    torch.set_num_threads(n)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ---- kernel 6

def _coefficients(rng, h, w, ncomp, sampling):
    """Random quantised blocks (small, as real ones) with the standard tables."""
    qy, qc = jpeg.quality_tables(int(rng.integers(50, 101)))
    hs, vs = sampling
    mx, my = -(-w // (8 * hs)), -(-h // (8 * vs))
    n = my * vs * mx * hs + (ncomp - 1) * mx * my
    coefs = np.clip(np.round(rng.laplace(0, 3, (n, 64))), -200, 200).astype(np.int16)
    coefs[:, 0] = rng.integers(-60, 60, n)
    return jpeg.Coefficients(h, w, sampling, np.stack([qy, qc, qc][:ncomp]).astype(np.int32),
                             coefs)


KINDS = [(3, (2, 2)), (3, (1, 1)), (1, (1, 1)), (3, (2, 2))]  # 4:2:0, 4:4:4, gray, 4:2:0


def _decode(libs, images, sms):
    """(kernel's RGB, plain RGB) of a batch, the kernel's tiles for `sms` SMs."""
    coefs, quant, meta, h, w = jpeg_idct.pack(images)
    want = jpeg_idct.decode_plain(*map(torch.from_numpy, (coefs, quant, meta)), h, w).numpy()
    got = np.random.default_rng(sms).integers(0, 256, want.shape, dtype=np.uint8)
    code = libs["jpeg_idct"](*map(_ptr, (coefs, quant, meta, got)), len(images), h, w, sms, None)
    assert code == 0
    return got, want


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("h, w", [(1, 1), (3, 5), (4, 4), (4, 3), (5, 5), (16, 16), (17, 23),
                                  (33, 47), (48, 32), (90, 160), (40, 700)])
def test_jpeg_kernel_matches_plain(libs, h, w, sms):
    """A batch mixing 4:2:0, 4:4:4 and one-component images at sizes off 16,
    of 1-3 MCUs a side (4:2:0 chroma 1-2 wide, where libjpeg replicates) and
    in strips across 700 pixels; with 132 SMs a CTA takes an MCU row or a
    few, with one it walks a band of several through its chroma ring."""
    rng = np.random.default_rng(h * 1000 + w)
    got, want = _decode(libs, [_coefficients(rng, h, w, *k) for k in KINDS], sms)
    np.testing.assert_array_equal(got, want)


def test_jpeg_kernel_at_full_size(libs):
    """One 4:2:0 image of 900x1600 (5 strips of 320 pixels, a band an MCU
    row) and two of 4:2:0 and 4:4:4 in bands of 19 MCU rows."""
    rng = np.random.default_rng(9)
    got, want = _decode(libs, [_coefficients(rng, 900, 1600, *KINDS[0])], 132)
    np.testing.assert_array_equal(got, want)
    got, want = _decode(libs, [_coefficients(rng, 900, 1600, *k) for k in KINDS[:2]], 1)
    np.testing.assert_array_equal(got, want)


def test_jpeg_bound_counts_the_batch():
    """Bytes: coefficients, tables and meta in, RGB out; operations: per
    block and per pixel by kind (none for one component), by pipe."""
    rng = np.random.default_rng(5)
    images = [_coefficients(rng, 17, 23, *k) for k in KINDS[:3]]
    coefs, quant, meta, h, w = jpeg_idct.pack(images)
    per = {"block": {"fma": 3, "alu": 5, "either": 0},
           "pixel_420": {"fma": 0, "alu": 2, "either": 1},
           "pixel_444": {"fma": 1, "alu": 0, "either": 0}}
    nbytes, ops = jpeg_idct.bound(meta, coefs.shape[0], h, w, per)
    assert nbytes == coefs.nbytes + quant.nbytes + meta.nbytes + 3 * h * w * 3
    assert ops == {"fma": 3 * coefs.shape[0] + h * w, "alu": 5 * coefs.shape[0] + 2 * h * w,
                   "either": h * w}


def test_sass_count_splits_the_pipes():
    """Multiplies to the FMA pipe, the rest of the integer ALU to its pipe,
    IMAD.MOV (a move), uniform, float and memory instructions not counted,
    only the kernels asked for."""
    sass = """
        Function : ops_probe_a
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   IMAD R2, R3, 0x1151, R4 ;
        /*0020*/                   IMAD.WIDE R4, R5, 0x4, R6 ;
        /*0030*/               @P0 IADD3 R2, R2, 0x400, RZ ;
        /*0040*/                   SHF.R.S32.HI R2, RZ, 0xb, R2 ;
        /*0050*/                   VIADD R7, R7, 0x1 ;
        /*0060*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0070*/                   FFMA R8, R8, R9, R10 ;
        /*0080*/                   LDG.E R9, desc[UR4][R4.64] ;
        Function : ops_probe_b
        /*0000*/                   LOP3.LUT R1, R1, 0xff, RZ, 0xc0, !PT ;
        Function : other
        /*0000*/                   IADD3 R1, R1, R2, RZ ;
    """
    counts = _build.count_int_ops(sass, ["ops_probe_a", "ops_probe_b"])
    assert counts == {"ops_probe_a": {"fma": 2, "alu": 2, "either": 1},
                      "ops_probe_b": {"fma": 0, "alu": 1, "either": 0}}


# ---- kernel 7

def _augment(libs, h, w, final_dim, draws, seed):
    """(kernel's output, plain output) of `draws` on random images."""
    rng = np.random.default_rng(seed)
    n = len(draws)
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    params, htab, vtab, rows = img_aug.plan(draws, h, w, final_dim)
    want = img_aug.augment_plain(torch.from_numpy(images),
                                 *map(torch.from_numpy, (params, htab, vtab)), final_dim).numpy()
    scratch = rng.integers(-2**31, 2**31, (n, max(rows, 1), -(-final_dim[1] // 4) * 4),
                           dtype=np.int32)
    got = rng.standard_normal(want.shape).astype(np.float32)
    code = libs["img_aug"](*map(_ptr, (images, params, htab, vtab, scratch, got)), n, h, w,
                           *final_dim, htab.shape[2], vtab.shape[2], rows, None)
    assert code == 0
    return got, want


AUG_CASES = {
    "train-v2's draws": (900, 1600, (128, 352), 4, None),
    "225x400 to 32x88": (225, 400, (32, 88), 8, None),
    "37x61 to 13x29": (37, 61, (13, 29), 8, None),
    "windows of 221 taps, staged in turns": (900, 1600, (13, 29), 3, None),
    "upsampling": (37, 61, (64, 128), 4, None),
    "rotations to 40 degrees": (90, 160, (32, 88), 8, (-40.0, 40.0)),
    "a crop 600 wide": (200, 700, (40, 600), 4, None),
}


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_img_aug_kernel_matches_plain(libs, case):
    """Train draws (flips, rotations, crops past the resized image, which
    are zero-filled) and every 4th the eval draw."""
    h, w, final_dim, n, rot_lim = AUG_CASES[case]
    rng = np.random.default_rng(h + w)
    conf = AugConfig(H=h, W=w, final_dim=final_dim, rand_flip=True,
                     **({} if rot_lim is None else {"rot_lim": rot_lim}))
    draws = [sample_augmentation(conf, i % 4 != 0, rng) for i in range(n)]
    if case == "train-v2's draws":
        assert any(p.resize_dims[0] < final_dim[1] for p in draws)
        assert any(p.flip for p in draws) and any(p.rotate == 0 for p in draws)
    got, want = _augment(libs, h, w, final_dim, draws, seed=n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("angle", [-5.4, -0.7, 0.3, 5.4, 40.0, -45.0, 135.0])
@pytest.mark.parametrize("flip", [False, True])
def test_img_aug_kernel_rotated_tiles(libs, angle, flip):
    """A rotated, flipped tile's footprint: the crop pixels its output
    pixels show lie in the box the vertical pass stages, for any angle (the
    box of a 32x32 tile is at most 48 rows tall)."""
    h, w, final_dim = 120, 200, (64, 96)
    conf = AugConfig(H=h, W=w, final_dim=final_dim, rand_flip=True)
    rng = np.random.default_rng(7)
    draws = [dataclasses.replace(sample_augmentation(conf, True, rng), rotate=angle, flip=flip)
             for _ in range(2)]
    got, want = _augment(libs, h, w, final_dim, draws, seed=3)
    np.testing.assert_array_equal(got, want)


def test_img_aug_bound_counts_the_taps():
    """The taps `bound` counts: every intermediate row's live columns'
    windows, and each output pixel inside the crop its row's window, as the
    plain version's coordinates give them."""
    h, w, final_dim = 225, 400, (32, 88)
    conf = AugConfig(H=h, W=w, final_dim=final_dim, rand_flip=True)
    rng = np.random.default_rng(11)
    draws = [sample_augmentation(conf, i % 4 != 0, rng) for i in range(8)]
    params, htab, vtab, _ = img_aug.plan(draws, h, w, final_dim)
    taps = 0
    for p, ht, vt in zip(params.tolist(), htab, vtab):
        taps += p[13] * int(ht[:, 1].sum())
        yc, _, inside = img_aug._source_coords(p, *final_dim, "cpu")
        taps += int(vt[yc.numpy(), 1][inside.numpy()].sum()) if p[13] else 0
    per = {"tap": {"fma": 1, "alu": 0, "either": 0}, "clip": {"fma": 0, "alu": 1, "either": 0},
           "source": {"fma": 0, "alu": 0, "either": 1}}
    _, ops = img_aug.bound(params, htab, vtab, h, w, final_dim, per)
    assert ops["fma"] == taps and ops["either"] == len(draws) * final_dim[0] * final_dim[1]
