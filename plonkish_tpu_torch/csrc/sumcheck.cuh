// K3, the sum-check round, as a kernel generated for each expression.
//
// K3 replaces plonkish_tpu/pallas/sumcheck.py::_round_kernel
// (sumcheck.py:159), which traces the expression into the kernel once per
// expression and size.  Here too every expression gets its own code:
// kernels/sumcheck_gen.py emits the expression's tape (piop/tape.py) as a
// struct `Tape` whose `eval` is one statement per instruction on named Fe
// locals, so that nvcc keeps the tape's registers in registers, and
// instantiates the templates below with it.  The constants' values are read
// from `consts` at run time: one kernel serves every proof whose expression
// has the same structure.  The field is the Tape's (`Tape::F`: Fr for
// HyperPlonk over BN254, Fq for HyperPlonk over Grumpkin's scalar field), and
// part of the generated source.
//
// One thread per (pair, t): a warp takes 32 neighbouring pairs at one t, and
// a block's warps take t = 1..d, so the d warps that read the same pairs
// share L1; blockIdx.y picks a share of the t when a block holds fewer warps
// (sc_round_config: when the registers allow d warps in a block only with
// too few warps on the SM, blocks are one warp each).  A leaf's value at t is hi + (t - 1)(hi - lo),
// formed by additions when it is loaded; the identity leaf at pair i is
// ids[1] + i * ids[0] + (t - 1) * ids[2] with a 64-bit pair index (ids[0]
// holds the raw digits of 2^(r+1) R^2 mod p, so its Montgomery product with
// the raw index is Montgomery).  The state keeps a fix_var pair as
// neighbouring rows (2i, 2i + 1).  Each thread sums its pairs over a
// grid-stride loop, a warp adds its lanes with shuffles and writes one partial
// sum per (block, t), and a second launch of one block adds the partials.
//
// Bound: integer multiply-adds (the tape's products at every pair and t).
//
// Every function but the kernels is __host__ __device__: the CPU tests build
// the same generated source with g++, where sc_round runs the kernel's
// threads one after another (tests/test_torch_sumcheck_gen.py).
#pragma once

#include "field.cuh"

namespace pk {

constexpr int SC_WARP = 32;
constexpr int SC_REDUCE_THREADS = 128;

// fe_mul for the tape's products: one out-of-line function that every
// product calls.  On an H100 it ran faster than a copy inlined at each
// product, on every tape measured (PERF.md).  g++ has no __noinline__.
#ifdef __CUDACC__
#define PK_SC_NOINLINE __noinline__
#else
#define PK_SC_NOINLINE __attribute__((noinline))
#endif

template <class F>
__host__ __device__ PK_SC_NOINLINE Fe sc_mul(const Fe a, const Fe b) {
  return fe_mul<F>(a, b);
}

// lo and hi of one pair: 64 contiguous bytes.
PK_HD void sc_load_pair(const uint32_t* p, Fe& lo, Fe& hi) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
  lo = Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  hi = Fe{{c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w}};
#else
  lo = fe_load(p);
  hi = fe_load(p + 8);
#endif
}

// Stacked row `row` of state [T, 2s, 8] at pair i and t = tm1 + 1.
template <class F>
PK_HD Fe sc_leaf(const uint32_t* state, int64_t s, int row, int64_t i, int tm1) {
  Fe lo, hi;
  sc_load_pair(state + ((int64_t)row * 2 * s + 2 * i) * 8, lo, hi);
  Fe step = fe_sub<F>(hi, lo);
  for (int k = 0; k < tm1; k++) hi = fe_add<F>(hi, step);
  return hi;
}

// The identity leaf at pair i and t = tm1 + 1.
template <class F>
PK_HD Fe sc_identity(const uint32_t* ids, int64_t i, int tm1) {
  Fe idx = fe_zero();
  idx.v[0] = (uint32_t)i;
  idx.v[1] = (uint32_t)((uint64_t)i >> 32);
  Fe v = fe_add<F>(sc_mul<F>(idx, fe_load(ids)), fe_load(ids + 8));
  Fe step = fe_load(ids + 16);
  for (int k = 0; k < tm1; k++) v = fe_add<F>(v, step);
  return v;
}

PK_HD Fe sc_const(const uint32_t* consts, int j) { return fe_load(consts + 8 * j); }

// One thread's sum of the expression at t = tm1 + 1 over pairs first,
// first + stride, ... below s.
template <class Tape>
PK_HD Fe sc_thread_sum(const uint32_t* state, int64_t s, const uint32_t* consts,
                       const uint32_t* ids, int tm1, int64_t first, int64_t stride) {
  Fe acc = fe_zero();
  for (int64_t i = first; i < s; i += stride)
    acc = fe_add<typename Tape::F>(acc, Tape::eval(state, s, i, tm1, consts, ids));
  return acc;
}

}  // namespace pk

#ifdef __CUDACC__

namespace pk {

// grid (blocks, ceil(d / warps)), block warps * 32; partial [blocks, d, 8].
template <class Tape>
__global__ void sc_round_kernel(const uint32_t* state, int64_t s,
                                const uint32_t* consts, const uint32_t* ids,
                                uint32_t* partial) {
  int tm1 = blockIdx.y * (blockDim.x / SC_WARP) + threadIdx.x / SC_WARP;
  if (tm1 >= Tape::DEGREE) return;  // a whole warp
  int lane = threadIdx.x % SC_WARP;
  Fe acc = sc_thread_sum<Tape>(state, s, consts, ids, tm1,
                               (int64_t)blockIdx.x * SC_WARP + lane,
                               (int64_t)gridDim.x * SC_WARP);
  for (int off = SC_WARP / 2; off > 0; off >>= 1) {
    Fe o;
#pragma unroll
    for (int w = 0; w < 8; w++) o.v[w] = __shfl_down_sync(0xffffffffu, acc.v[w], off);
    acc = fe_add<typename Tape::F>(acc, o);
  }
  if (lane == 0) fe_store(partial + ((int64_t)blockIdx.x * Tape::DEGREE + tm1) * 8, acc);
}

// One block: out[t] = sum of partial[b, t] over the blocks.
template <class F>
__global__ void sc_reduce_kernel(const uint32_t* partial, int blocks,
                                        int degree, uint32_t* out) {
  __shared__ uint32_t sh[SC_REDUCE_THREADS * 8];
  int tid = threadIdx.x;
  for (int t = 0; t < degree; t++) {
    Fe acc = fe_zero();
    for (int b = tid; b < blocks; b += SC_REDUCE_THREADS)
      acc = fe_add<F>(acc, fe_load(partial + ((int64_t)b * degree + t) * 8));
    fe_store(sh + tid * 8, acc);
    __syncthreads();
    for (int w = SC_REDUCE_THREADS / 2; w > 0; w >>= 1) {
      if (tid < w)
        fe_store(sh + tid * 8, fe_add<F>(fe_load(sh + tid * 8), fe_load(sh + (tid + w) * 8)));
      __syncthreads();
    }
    if (tid == 0) fe_store(out + t * 8, fe_load(sh));
    __syncthreads();
  }
}

template <class Tape>
int sc_round_run(const uint32_t* state, long long s, const uint32_t* consts,
                 const uint32_t* ids, int blocks, int warps, uint32_t* partial,
                 uint32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(blocks, (Tape::DEGREE + warps - 1) / warps);
  sc_round_kernel<Tape><<<grid, warps * SC_WARP, 0, st>>>(state, s, consts, ids, partial);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sc_reduce_kernel<typename Tape::F><<<1, SC_REDUCE_THREADS, 0, st>>>(partial, blocks,
                                                                    Tape::DEGREE, out);
  return (int)cudaGetLastError();
}

// The launch shape: out = warps per block, resident blocks on the card,
// registers per thread, local memory (stack) bytes per thread.  Blocks hold
// d warps (the d values of t share the pairs' reads in L1) unless the
// registers' split over the SM's four schedulers lets such blocks keep
// fewer than 3/4 of the warps that blocks of one warp keep resident.
template <class Tape>
int sc_round_config(int* out) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, sc_round_kernel<Tape>);
  if (rc != 0) return rc;
  int warps = a.maxThreadsPerBlock / SC_WARP;
  if (warps > Tape::DEGREE) warps = Tape::DEGREE;
  int per_sm = 0, single = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sc_round_kernel<Tape>,
                                                          warps * SC_WARP, 0);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&single, sc_round_kernel<Tape>,
                                                            SC_WARP, 0);
  if (rc == 0) rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != 0) return rc;
  if (4 * warps * per_sm < 3 * single) {
    warps = 1;
    per_sm = single;
  }
  out[0] = warps;
  out[1] = per_sm * sms;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace pk

#else  // the host build of the CPU tests

namespace pk {

// The kernel's threads one after another, block by block and lane by lane,
// then the reduction over the blocks.
template <class Tape>
int sc_round_run(const uint32_t* state, long long s, const uint32_t* consts,
                 const uint32_t* ids, int blocks, int warps, uint32_t* partial,
                 uint32_t* out, void* stream) {
  (void)warps, (void)stream;
  for (int b = 0; b < blocks; b++) {
    for (int tm1 = 0; tm1 < Tape::DEGREE; tm1++) {
      Fe acc = fe_zero();
      for (int lane = 0; lane < SC_WARP; lane++)
        acc = fe_add<typename Tape::F>(acc, sc_thread_sum<Tape>(state, s, consts, ids, tm1,
                                                  (int64_t)b * SC_WARP + lane,
                                                  (int64_t)blocks * SC_WARP));
      fe_store(partial + ((int64_t)b * Tape::DEGREE + tm1) * 8, acc);
    }
  }
  for (int tm1 = 0; tm1 < Tape::DEGREE; tm1++) {
    Fe acc = fe_zero();
    for (int b = 0; b < blocks; b++)
      acc = fe_add<typename Tape::F>(acc,
                                     fe_load(partial + ((int64_t)b * Tape::DEGREE + tm1) * 8));
    fe_store(out + tm1 * 8, acc);
  }
  return 0;
}

// A small card: 3 resident blocks, so that a few hundred pairs already
// take several turns of the grid-stride loop.
template <class Tape>
int sc_round_config(int* out) {
  out[0] = Tape::DEGREE;
  out[1] = 3;
  out[2] = 0;
  out[3] = 0;
  return 0;
}

}  // namespace pk

#endif  // __CUDACC__
