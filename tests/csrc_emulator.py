"""Run the CUDA sources of ``hmcmt2d_tpu_torch/csrc`` on the CPU.

A thread-per-CUDA-thread emulation for tests: each source is compiled with
g++ against a small ``cuda_runtime.h`` of this module's own, in which every
CUDA thread of a block is an OS thread, ``__syncthreads``, ``__syncwarp``
and the named barriers are barriers over those threads, a shuffle goes
through a slot array of the warp, and dynamic shared memory is one
buffer, filled with NaN before each block.  Blocks run one after another.
A warp is 32 threads of consecutive linear index, as on the card.  The
sweeps' TMA ring (``csrc/tma_ring.cuh``) gets host versions of its
helpers: a cp.async is a plain copy, a bulk copy a ``memcpy`` that then
completes its mbarrier's phase, an mbarrier the count of its completed
phases in the emulated shared memory, and the fences do nothing; the
header's other definitions are its own.  Only the kernel launches
(``kernel<<<grid, block, smem, stream>>>(...)``)
are rewritten, into ``emu::launch(grid, block, smem, stream, kernel, ...)``,
and each ``extern __shared__ T name[];`` into a pointer to that buffer;
the rest of each source compiles as it is, so the emulation runs the
kernels' own indexing, barriers and arithmetic (in the host's rounding,
without nvcc's contractions).  It cannot say how fast a kernel is or
whether nvcc accepts it.

``build(out_dir)`` returns the loaded library, with the C entry points
``hmc_gj_inverse``, ``hmc_schur_factor``, ``hmc_bt_sweep_fwd``,
``hmc_bt_sweep_bwd``, ``hmc_mt1d_field`` and ``hmc_mt1d_vjp`` of the
sources, and ``emu_faults()``: the bulk copies so far whose addresses or
size a TMA copy would refuse (not 16-byte multiples).
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "hmcmt2d_tpu_torch" / "csrc"
SOURCES = ("gj_inverse.cu", "schur_factor.cu", "bt_sweep.cu", "mt1d_field.cu")
SMEM_BYTES = 232_448

RUNTIME_H = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <atomic>
#include <barrier>
#include <condition_variable>
#include <cstddef>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
#define __restrict__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline int min(int a, int b) { return a < b ? a : b; }
extern thread_local dim3 threadIdx, blockIdx, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __drcp_rn(double x) { return 1.0 / x; }
namespace emu {
extern unsigned char shared_mem[];
extern thread_local int warp, lane;   // the calling thread's linear index / 32, % 32
extern std::atomic<int> faults;
struct Named {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  long gen = 0;
};
extern std::barrier<>* block_bar;
extern std::barrier<>* warp_bar[32];
extern unsigned char slot[32][32][16];
extern Named named[16];
inline void named_arrive(int id, int count, bool wait) {
  std::unique_lock<std::mutex> lk(named[id].m);
  const long g = named[id].gen;
  if (++named[id].arrived == count) {
    named[id].arrived = 0;
    ++named[id].gen;
    named[id].cv.notify_all();
  } else if (wait) {
    named[id].cv.wait(lk, [&] { return named[id].gen != g; });
  }
}
template <typename F, typename... Args>
void launch(unsigned grid, dim3 block, int smem_bytes, cudaStream_t, F kernel, Args... args) {
  if (smem_bytes > SMEM_BYTES) throw smem_bytes;
  const unsigned nt = block.x * block.y, nw = (nt + 31) / 32;
  for (unsigned b = 0; b < grid; ++b) {
    std::memset(shared_mem, 0xff, SMEM_BYTES);
    std::barrier<> bb(nt);
    block_bar = &bb;
    for (unsigned w = 0; w < nw; ++w) warp_bar[w] = new std::barrier<>(std::min(32u, nt - 32 * w));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([=]() {
        threadIdx = dim3(t % block.x, t / block.x);
        blockIdx = dim3(b);
        gridDim = dim3(grid);
        warp = t / 32;
        lane = t % 32;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
    for (unsigned w = 0; w < nw; ++w) delete warp_bar[w];
  }
}
}  // namespace emu
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_bar[emu::warp]->arrive_and_wait(); }
template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  const int w = emu::warp, l = emu::lane;
  std::memcpy(emu::slot[w][l], &v, sizeof(T));
  emu::warp_bar[w]->arrive_and_wait();
  T out;
  std::memcpy(&out, emu::slot[w][src & 31], sizeof(T));
  emu::warp_bar[w]->arrive_and_wait();
  return out;
}
template <typename T>
T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
  return __shfl_sync(mask, v, emu::lane ^ lane_mask);
}
""".replace("SMEM_BYTES", str(SMEM_BYTES))

NAMED_BARRIER_H = r"""
#pragma once
inline void bar_arrive(int id, int count) { emu::named_arrive(id, count, false); }
inline void bar_sync(int id, int count) { emu::named_arrive(id, count, true); }
"""

# the host versions of csrc/tma_ring.cuh's PTX helpers
TMA_RING_H = r"""
#pragma once
#include <cstring>
#include <thread>
inline void cp_async4(float* dst, const float* src) { *dst = *src; }
inline void cp_async8(float2* dst, const float2* src) { *dst = *src; }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void fence_proxy_async() {}
// an mbarrier: the count of its completed phases; a wait on parity p returns
// once the phase of that parity has completed
inline std::atomic_ref<uint64_t> mbar(uint64_t* bar) { return std::atomic_ref<uint64_t>(*bar); }
inline void mbar_init(uint64_t* bar) { mbar(bar).store(0); }
inline void mbar_init_fence() {}
// an arrive that expects no bytes completes the phase; else the copy does
inline void mbar_expect(uint64_t* bar, unsigned bytes) {
  if (bytes == 0) mbar(bar).fetch_add(1);
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while ((mbar(bar).load() & 1u) == parity) std::this_thread::yield();
}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  if (bytes == 0 || bytes % 16 || reinterpret_cast<uintptr_t>(dst) % 16 ||
      reinterpret_cast<uintptr_t>(src) % 16)
    ++emu::faults;
  else
    std::memcpy(dst, src, bytes);
  mbar(bar).fetch_add(1);
}
"""

GLOBALS_CPP = r"""
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx, gridDim;
namespace emu {
thread_local int warp, lane;
std::atomic<int> faults{0};
alignas(16) unsigned char shared_mem[SMEM_BYTES];
std::barrier<>* block_bar;
std::barrier<>* warp_bar[32];
unsigned char slot[32][32][16];
Named named[16];
}  // namespace emu
extern "C" int emu_faults() { return emu::faults; }
""".replace("SMEM_BYTES", str(SMEM_BYTES))

# kernel<...><<<grid, block, smem, stream>>>(  ->  emu::launch(grid, ..., kernel,
LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>]*>)?)<<<(.*?)>>>\(")
# extern __shared__ [__align__(16)] T name[];  ->  T* name = (T*)emu::shared_mem;
SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];")


def available() -> bool:
    return shutil.which("g++") is not None


def host_tma_ring() -> str:
    """TMA_RING_H and, as they are, the definitions of ``csrc/tma_ring.cuh``
    that hold no inline PTX (``span_shift``, ``Chunks``)."""
    blocks = (CSRC / "tma_ring.cuh").read_text().split("\n\n")[1:]   # past the includes
    return TMA_RING_H + "\n\n".join(b for b in blocks if "asm" not in b
                                     and "smem_addr" not in b)


def build(out_dir: Path) -> ctypes.CDLL:
    """Compile the emulated sources into ``out_dir`` and load them."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(RUNTIME_H)
    (out_dir / "named_barrier.cuh").write_text(NAMED_BARRIER_H)
    (out_dir / "tma_ring.cuh").write_text(host_tma_ring())
    (out_dir / "globals.cpp").write_text(GLOBALS_CPP)
    units = [out_dir / "globals.cpp"]
    for name in SOURCES:
        text = LAUNCH.sub(r"emu::launch(\2, \1, ", (CSRC / name).read_text())
        text = SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(emu::shared_mem);", text)
        unit = out_dir / (Path(name).stem + ".cpp")
        unit.write_text(text)
        units.append(unit)
    flags = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-w", "-I", str(out_dir),
             "-I", str(CSRC), "-include", "cuda_runtime.h"]
    procs = [subprocess.Popen(["g++", *flags, "-c", str(u), "-o", str(u.with_suffix(".o"))],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u in units]
    for u, p in zip(units, procs):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed on {u.name}:\n{log}")
    lib = out_dir / "libcsrc_emulated.so"
    subprocess.run(["g++", "-shared", "-pthread", *[str(u.with_suffix(".o")) for u in units],
                    "-o", str(lib)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.hmc_gj_inverse.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    dll.hmc_schur_factor.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                     + [ctypes.c_void_p])
    for fn in (dll.hmc_bt_sweep_fwd, dll.hmc_bt_sweep_bwd):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    dll.hmc_mt1d_field.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
    dll.hmc_mt1d_vjp.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])
    for fn in (dll.hmc_gj_inverse, dll.hmc_schur_factor, dll.hmc_bt_sweep_fwd,
               dll.hmc_bt_sweep_bwd, dll.hmc_mt1d_field, dll.hmc_mt1d_vjp, dll.emu_faults):
        fn.restype = ctypes.c_int
    return dll
