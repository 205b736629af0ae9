// K3: batched Riccati LQR-KKT solve, one thread per batch element, the
// block's elements staged through shared memory.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/riccati_pallas.py::
// batched_lqr_kkt_solve (_riccati_kernel). Same function: the backward
// Riccati recursion over the dense stage blocks and the forward rollout from
// dx0, returning (dx, du, λ); reg is added to Quu before its Cholesky
// factorization. The recursion itself is riccati_solve in riccati_common.cuh,
// shared with K4.
//
// Design: (T, NX, NU) are template parameters, so the stage loops unroll and
// the per-stage K, k, P, p stay in registers; one thread solves one element.
// The data movement is the block's. A block serves kElementsPerBlock
// elements (which ops/riccati_cuda.py's ELEMENTS_PER_BLOCK mirrors). Each
// of the nine inputs holds the block's elements in one contiguous range of
// the callers' batch-major layout; one thread copies each range's 16-byte-aligned body
// into dynamic shared memory with a 1-D bulk asynchronous copy
// (cp.async.bulk, completing on an mbarrier whose transaction count is the
// bodies' bytes), while the block's threads copy the scalars before and
// after it (a caller's slice need not start on 16 bytes). After the barrier
// each thread reads its element from the ranges into registers, solves, and
// stores its element's dx, du and λ straight from registers. The arithmetic
// is riccati_solve's, unchanged: the outputs are the bits of the kernel that
// loaded its element from global memory with scalar loads.
//
// Why: a warp of that kernel read its elements 80 B apart (Cxx at (5, 2, 1),
// float32), so one load instruction touched ~20 cache lines, and a launch of
// 64 elements ran on one SM. The staged copies touch each line once, and 64
// elements spread over EPB-element blocks on several SMs. Cooperative
// 16-byte vector loads into records of an odd stride were the other way to
// stage the ranges; as written, each range's loads waited for the stores
// before them, and they took 3-4 times the bulk copy's time at every shape
// and batch timed on an NVIDIA H100 80GB HBM3 at 700 W. Staging the outputs
// too (records of an odd stride, then 16-byte vector stores) gave the same
// bits and won no path's batch beyond the spread (PERF.md, Findings).
//
// Bound on the H100: ~480 flops and ~440 bytes (float32) per element at
// the ip path's shape (T 5, nx 2, nu 1), so the card's bound is the bytes;
// at 64 elements (the closed loop's batch) a launch is latency-bound, a few
// µs above the device's fixed cost per launch. Serving an element with a
// group of lanes was measured and lost (PERF.md, Findings): each sub-step is
// a few multiply-adds, and the chain of IEEE divisions and square roots
// stays as deep.
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "riccati_common.cuh"

namespace dqmpc {

template <int A>
using Input = std::integral_constant<int, A>;

// Calls f(Input<0>{}) … f(Input<8>{}): one call per input, so that an
// input's sizes and offsets are constants where f uses them.
template <class Fn>
__device__ __forceinline__ void each_input(Fn f) {
  f(Input<0>{});
  f(Input<1>{});
  f(Input<2>{});
  f(Input<3>{});
  f(Input<4>{});
  f(Input<5>{});
  f(Input<6>{});
  f(Input<7>{});
  f(Input<8>{});
}

// An element's entries in each of the nine inputs (in the kernel's argument
// order). The block's shared memory holds one region per input with the
// block's range as it lies in global memory (16 bytes spare for its start's
// offset within 16 bytes), then the mbarrier.
template <int T, int NX, int NU>
struct StagedLayout {
  __host__ __device__ static constexpr int size(int a) {
    return a == 0   ? T * NX * NX
           : a == 1 ? T * NX * NU
           : a == 2 ? T * NU * NU
           : a == 3 ? T * NX
           : a == 4 ? T * NU
           : a == 5 ? (T - 1) * NX * NX
           : a == 6 ? (T - 1) * NX * NU
           : a == 7 ? (T - 1) * NX
                    : NX;
  }
  template <typename F, int EPB>
  __host__ __device__ static constexpr int region_bytes(int a) {
    return (EPB * size(a) * static_cast<int>(sizeof(F)) + 16 + 15) / 16 * 16;
  }
  template <typename F, int EPB>
  __host__ __device__ static constexpr int region_offset(int a) {
    return a == 0 ? 0
                  : region_offset<F, EPB>(a - 1) + region_bytes<F, EPB>(a - 1);
  }
  // bytes of dynamic shared memory a block takes
  template <typename F, int EPB>
  __host__ __device__ static constexpr int smem_bytes() {
    return region_offset<F, EPB>(9) + 16;
  }
};

// The elements a block serves: of 16, 32 and 64 the fastest at every shape
// and dtype at the paths' B 64 and 256, timed in turns on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md, Findings).
constexpr int kElementsPerBlock = 16;

template <int EPB>
__host__ __device__ constexpr int staged_threads() {
  return EPB < 32 ? 32 : EPB;
}

// Scalars before a range at g reaches a 16-byte boundary (at most n).
template <typename F>
__device__ __forceinline__ int aligned_head(const F* g, int n) {
  const int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(F));
  return head < n ? head : n;
}

// Scalars of the 16-byte-aligned body of the n scalars at g.
template <typename F>
__device__ __forceinline__ int aligned_body(const F* g, int n) {
  const int head = aligned_head(g, n);
  constexpr int kVec = 16 / static_cast<int>(sizeof(F));
  return (n - head) / kVec * kVec;
}

// ---- the bulk copy and its mbarrier (the card; the CPU emulation of
// utils/warp_emu.py copies at once and waits at the block's barrier) ----
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
#ifdef __CUDA_ARCH__
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(a) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#else
  *bar = 0;
#endif
}

// The one arrival the mbarrier waits for, with the bytes the bulk copies
// will complete.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
#ifdef __CUDA_ARCH__
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   a),
               "r"(bytes)
               : "memory");
#else
  *bar += bytes;
#endif
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
#else
  std::memcpy(dst, src, bytes);
#endif
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
#ifdef __CUDA_ARCH__
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a)
        : "memory");
  } while (!done);
#endif
}

template <int T, int NX, int NU, typename F>
__global__ void __launch_bounds__(staged_threads<kElementsPerBlock>())
riccati_kernel(const F* __restrict__ Cxx_g, const F* __restrict__ Cxu_g,
               const F* __restrict__ Cuu_g, const F* __restrict__ gx_g,
               const F* __restrict__ gu_g, const F* __restrict__ A_g,
               const F* __restrict__ B_g, const F* __restrict__ r_g,
               const F* __restrict__ dx0_g, F* __restrict__ dx_g,
               F* __restrict__ du_g, F* __restrict__ lam_g, int Bsz, F reg) {
  using L = StagedLayout<T, NX, NU>;
  constexpr int EPB = kElementsPerBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * EPB;
  const int ne = Bsz - e0 < EPB ? Bsz - e0 : EPB;
  const size_t E0 = static_cast<size_t>(e0);
  const F* g[9] = {Cxx_g + E0 * L::size(0), Cxu_g + E0 * L::size(1),
                   Cuu_g + E0 * L::size(2), gx_g + E0 * L::size(3),
                   gu_g + E0 * L::size(4),  A_g + E0 * L::size(5),
                   B_g + E0 * L::size(6),   r_g + E0 * L::size(7),
                   dx0_g + E0 * L::size(8)};
  // input A's range in shared memory, at its start's offset within 16
  // bytes, so that its body lands 16-byte aligned
  auto staged = [&](auto a) {
    constexpr int A = decltype(a)::value;
    return reinterpret_cast<F*>(
        smem + L::template region_offset<F, EPB>(A) +
        (reinterpret_cast<uintptr_t>(g[A]) & 15));
  };
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      smem + L::template region_offset<F, EPB>(9));
  if (tid == 0) {  // the copies start before the block's first barrier
    mbar_init(bar);
    unsigned bytes = 0;
    each_input([&](auto a) {
      constexpr int A = decltype(a)::value;
      bytes += aligned_body(g[A], ne * L::size(A)) * sizeof(F);
    });
    mbar_expect(bar, bytes);
    each_input([&](auto a) {
      constexpr int A = decltype(a)::value;
      const int n = ne * L::size(A), head = aligned_head(g[A], n);
      const int body = aligned_body(g[A], n);
      if (body > 0)
        bulk_copy(staged(a) + head, g[A] + head,
                  static_cast<unsigned>(body * sizeof(F)), bar);
    });
  }
  __syncthreads();  // the mbarrier initialized before any thread waits on it
  each_input([&](auto a) {  // the scalars before and after each body
    constexpr int A = decltype(a)::value;
    const int n = ne * L::size(A), head = aligned_head(g[A], n);
    const int tail = head + aligned_body(g[A], n);
    if (tid < head) staged(a)[tid] = g[A][tid];
    if (tail + tid < n) staged(a)[tail + tid] = g[A][tail + tid];
  });
  mbar_wait(bar);
  __syncthreads();

  if (tid < ne) {
    const F* Cxx_s = staged(Input<0>{}) + tid * L::size(0);
    const F* Cxu_s = staged(Input<1>{}) + tid * L::size(1);
    const F* Cuu_s = staged(Input<2>{}) + tid * L::size(2);
    const F* gx_s = staged(Input<3>{}) + tid * L::size(3);
    const F* gu_s = staged(Input<4>{}) + tid * L::size(4);
    const F* A_s = staged(Input<5>{}) + tid * L::size(5);
    const F* B_s = staged(Input<6>{}) + tid * L::size(6);
    const F* r_s = staged(Input<7>{}) + tid * L::size(7);
    const F* dx0_s = staged(Input<8>{}) + tid * L::size(8);
    LQRProblem<T, NX, NU, F> prob;
    F Cuu[T][NU][NU], gx[T][NX], gu[T][NU], r[T - 1][NX], dx0[NX];
    F dx[T][NX], du[T][NU], lam[T][NX];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        gx[t][i] = gx_s[t * NX + i];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          prob.Cxx[t][i][j] = Cxx_s[(t * NX + i) * NX + j];
#pragma unroll
        for (int j = 0; j < NU; ++j)
          prob.Cxu[t][i][j] = Cxu_s[(t * NX + i) * NU + j];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        gu[t][i] = gu_s[t * NU + i];
#pragma unroll
        for (int j = 0; j < NU; ++j)
          Cuu[t][i][j] = Cuu_s[(t * NU + i) * NU + j];
      }
    }
#pragma unroll
    for (int t = 0; t < T - 1; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        r[t][i] = r_s[t * NX + i];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          prob.A[t][i][j] = A_s[(t * NX + i) * NX + j];
#pragma unroll
        for (int j = 0; j < NU; ++j)
          prob.B[t][i][j] = B_s[(t * NX + i) * NU + j];
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) dx0[i] = dx0_s[i];
    riccati_solve<T, NX, NU, F>(prob, Cuu, gx, gu, r, dx0, reg, dx, du, lam);
    const size_t E = E0 + tid;
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        dx_g[(E * T + t) * NX + i] = dx[t][i];
        lam_g[(E * T + t) * NX + i] = lam[t][i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) du_g[(E * T + t) * NU + i] = du[t][i];
    }
  }
}

struct RiccatiArgs {
  const void *Cxx, *Cxu, *Cuu, *gx, *gu, *A, *B, *r, *dx0;
  void *dx, *du, *lam;
};

// Shared memory of the (T, NX, NU, F) instantiation: its elements a
// block, bytes an element (its inputs) and a block, and the most a block
// may ask of the current device.
template <int T, int NX, int NU, typename F>
int staged_smem(int* elements_per_block, int* per_element, int* per_block,
                int* device_max) {
  using L = StagedLayout<T, NX, NU>;
  constexpr int EPB = kElementsPerBlock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(device_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int per = 0;
  for (int a = 0; a < 9; ++a) per += L::size(a);
  *elements_per_block = EPB;
  *per_element = per * static_cast<int>(sizeof(F));
  *per_block = L::template smem_bytes<F, EPB>();
  return static_cast<int>(err);
}

template <int T, int NX, int NU, typename F>
int launch(const RiccatiArgs& a, int Bsz, double reg, cudaStream_t s) {
  constexpr int EPB = kElementsPerBlock;
  constexpr int bytes = StagedLayout<T, NX, NU>::template smem_bytes<F, EPB>();
  auto kernel = riccati_kernel<T, NX, NU, F>;
  if (bytes > 48 * 1024) {
    int epb = 0, per_element = 0, per_block = 0, device_max = 0;
    cudaError_t err = static_cast<cudaError_t>(staged_smem<T, NX, NU, F>(
        &epb, &per_element, &per_block, &device_max));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bytes > device_max)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (Bsz + EPB - 1) / EPB;
  kernel<<<blocks, staged_threads<EPB>(), bytes, s>>>(
      static_cast<const F*>(a.Cxx), static_cast<const F*>(a.Cxu),
      static_cast<const F*>(a.Cuu), static_cast<const F*>(a.gx),
      static_cast<const F*>(a.gu), static_cast<const F*>(a.A),
      static_cast<const F*>(a.B), static_cast<const F*>(a.r),
      static_cast<const F*>(a.dx0), static_cast<F*>(a.dx),
      static_cast<F*>(a.du), static_cast<F*>(a.lam), Bsz,
      static_cast<F>(reg));
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: the pendulum's ip path (5, 2, 1), its slew-augmented
// (5, 3, 1), the profiler's (5, 3, 2) and (5, 4, 1), and cp2's ip path
// (5, 6, 1).
#define RICCATI_SHAPES(X) X(5, 2, 1) X(5, 3, 1) X(5, 3, 2) X(5, 4, 1) X(5, 6, 1)

template <typename F>
int dispatch(const RiccatiArgs& a, int Bsz, int T, int nx, int nu,
             double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_LAUNCH(TT, NXX, NUU)   \
  if (T == TT && nx == NXX && nu == NUU) \
    return launch<TT, NXX, NUU, F>(a, Bsz, reg, s);
  RICCATI_SHAPES(RICCATI_LAUNCH)
#undef RICCATI_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int smem(int T, int nx, int nu, int* elements_per_block, int* per_element,
         int* per_block, int* device_max) {
#define RICCATI_SMEM(TT, NXX, NUU)                                 \
  if (T == TT && nx == NXX && nu == NUU)                           \
    return staged_smem<TT, NXX, NUU, F>(elements_per_block, per_element, \
                                        per_block, device_max);
  RICCATI_SHAPES(RICCATI_SMEM)
#undef RICCATI_SMEM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dqmpc

// Cxx [B,T,nx,nx], Cxu [B,T,nx,nu], Cuu [B,T,nu,nu], gx [B,T,nx],
// gu [B,T,nu], A [B,T-1,nx,nx], B [B,T-1,nx,nu], r [B,T-1,nx], dx0 [B,nx]
// -> dx [B,T,nx], du [B,T,nu], lam [B,T,nx]; each contiguous, at any
// offset of its scalar type's alignment. Built for the (T, nx, nu) of
// RICCATI_SHAPES; cudaErrorInvalidValue otherwise (riccati_horizon_warp.cu
// takes longer horizons), cudaErrorInvalidConfiguration when a block's
// shared memory exceeds what the device allows. Returns a cudaError_t code.
#define RICCATI_ENTRY(NAME, F)                                                \
  extern "C" int NAME(const void* Cxx, const void* Cxu, const void* Cuu,     \
                      const void* gx, const void* gu, const void* A,         \
                      const void* B, const void* r, const void* dx0,         \
                      void* dx, void* du, void* lam, int Bsz, int T, int nx, \
                      int nu, double reg, void* stream) {                    \
    dqmpc::RiccatiArgs a{Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0, dx, du, lam};   \
    return dqmpc::dispatch<F>(a, Bsz, T, nx, nu, reg, stream);               \
  }

RICCATI_ENTRY(riccati_f32, float)
RICCATI_ENTRY(riccati_f64, double)

// Shared memory of the (T, nx, nu, dtype) instantiation (see
// dqmpc::staged_smem). Returns a cudaError_t code.
#define RICCATI_SMEM_ENTRY(NAME, F)                                          \
  extern "C" int NAME(int T, int nx, int nu, int* elements_per_block,        \
                      int* per_element, int* per_block, int* device_max) {   \
    return dqmpc::smem<F>(T, nx, nu, elements_per_block, per_element,        \
                          per_block, device_max);                            \
  }

RICCATI_SMEM_ENTRY(riccati_smem_f32, float)
RICCATI_SMEM_ENTRY(riccati_smem_f64, double)
