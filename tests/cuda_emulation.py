"""A CUDA source of the port compiled for the CPU, for tests on machines
without a card: g++ builds it against a stand-in ``cuda_runtime.h`` in
which each CUDA thread of a block is a ``std::thread``, ``__syncthreads``
a ``std::barrier`` of the block, each ``_rn`` intrinsic the same IEEE
operation on the host (``-ffp-contract=off``: nothing is fused) and a
launch ``kernel<<<grid, block, smem, stream>>>(args)`` the block's
threads walking the grid's blocks one after another. The host's libm
stands in for libdevice, so ``sinf`` and ``atan2f`` may differ from the
card's by a few ulps.

It covers the subset the kernels that use it call (one-dimensional
blocks, a grid of up to two dimensions, static ``__shared__`` arrays,
which the block's threads share and the blocks, run one after another,
take over in turn; no atomics):
``emulated(source, directory)`` returns the ``ctypes.CDLL``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0);
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return cudaSuccess;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __double2float_rn(double a) { return static_cast<float>(a); }
inline float __ll2float_rn(long long a) { return static_cast<float>(a); }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::isnan;
using std::max;
using std::min;
inline void emu_launch(dim3 grid, dim3 block,
                       const std::function<void()>& body) {
  // one host thread a thread of the block, walking the grid's blocks in
  // turn; a barrier after each block, so the next one finds its shared
  // arrays free
  std::barrier<> bar(block.x);
  emu_barrier = &bar;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = dim3(bx, by);
          body();
          bar.arrive_and_wait();
        }
    });
  for (auto& th : threads) th.join();
}
"""

_LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\((.*?)\);", re.S)


def _launch(m: re.Match) -> str:
    grid, block = [p.strip() for p in m.group(2).split(",")][:2]
    return (f"emu_launch(dim3({grid}), dim3({block}), [&] "
            f"{{ {m.group(1)}({m.group(3)}); }});")


def available() -> bool:
    return shutil.which("g++") is not None


def emulated(source: Path, directory: Path) -> ctypes.CDLL:
    """Compile ``source`` (a ``csrc/*.cu`` file) for the CPU under the
    stand-in header into ``directory`` and load it."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "cuda_runtime.h").write_text(HEADER)
    cpp = directory / (source.stem + ".cpp")
    cpp.write_text(_LAUNCH.sub(_launch, source.read_text()))
    lib = directory / ("lib" + source.stem + ".so")
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
           "-shared", f"-I{directory}", "-include", "cuda_runtime.h", "-o",
           str(lib), str(cpp), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))
