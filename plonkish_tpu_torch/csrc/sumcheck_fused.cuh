// K7, the fused sum-check rounds: every round of an Evaluations sum-check
// from a given one to the last, in one cooperative launch.
//
// Port-only: no Pallas kernel corresponds.  K7 stands for the JAX package's
// fused-round programs, plonkish_tpu/piop/sum_check.py:573
// (_fused_packed_round_jit: a packed round's evaluations, device-FS message
// and fold as one XLA program) and :609 (_fused_tail_scan_jit: every round
// below the handover in one lax.scan).  The per-round path launches K3's
// round and reduce, K6 and K4 for each round, three to four dependent
// launches, most of them far shorter than a launch below 2^12 pairs.  Here
// one kernel loops over the rounds itself, the round index and the pair
// count as run-time data, so one kernel serves every k.
//
// Each round r, on a grid whose blocks are all resident (a cooperative
// launch sized by the occupancy of this kernel), with a grid-wide barrier
// between the phases:
//   (a) the warps sum the Tape over the pairs at t = 1..d (K3's body,
//       sc_thread_sum: 32 neighbouring pairs, then a stride; each t of a set
//       of pairs on a warp of its own where the warps suffice,
//       sc_fused_deal) and write partial sums [set of pairs, d];
//   (b) block 0 adds the partials (each thread a share of the blocks that
//       held pairs, then the warps' sums), and its warp 0 runs K6's round
//       message on them (fs_warp.cuh): absorb, squeeze, the challenge, the
//       next sum and identity offset, row r of `out`, the challenge in
//       Montgomery form and the next round's identity rows (`ids`, which
//       phase (a) reads);
//   (c) every block folds every table at the challenge (K4's fold_element,
//       a few elements a thread loaded before any is written), out of place
//       into the other of two buffers: the state the launch starts from,
//       then one of half its size, alternately.
// The blocks are as large as the registers allow while keeping the most
// warps resident (sc_fused_config), so that few blocks meet at a barrier.  A
// round keeps as many blocks at work as its pairs and its fold need
// (sc_fused_active, all of them in a large round); the count falls with the
// rounds, and a block past it leaves the kernel.  The barrier is a counter
// in device memory that each working block's thread 0 adds to, the flip of
// its top bit marking the last arrival (the arrangement of
// cooperative_groups' grid sync, for the blocks still at work, with the
// counter passed in: zero before the first launch, and back to a zero
// count after every barrier).  Tables that a block wrote are read by other
// blocks in the next phase, so the Tape's loads are coherent ones
// (sumcheck.cuh sc_load_pair).
//
// Bound: in a large round, K3's multiply-adds (and K4's bytes); in the tail,
// the dependent chain of K6's message and the barriers.  Field additions
// are exact, so the sums agree with the per-round path bit for bit,
// whatever the number of blocks.
//
// The phases' bodies are __host__ __device__: the CPU tests build the
// generated source with g++, where sc_fused_run runs phase (a) warp by warp
// on a small card of 3 resident blocks of 4 warps, then (b), then (c)
// (tests/test_torch_sumcheck_gen.py).
#pragma once

#include "fs_warp.cuh"
#include "sumcheck.cuh"

namespace pk {

constexpr int SC_FUSED_MAX_WARPS = 32;

// What a launch works on (every pointer a device buffer of int32 words).
struct ScFused {
  uint32_t* a;              // the state at the first round [T, 2 s0, 8]; even rounds read it
  uint32_t* b;              // [T, s0, 8]: odd rounds read it
  long long tables, s0;     // T and the pairs of the first round
  const uint32_t* consts;   // the Tape's constants
  uint32_t* ids;            // [3, 8] this round's identity rows (mul, base, step)
  uint32_t* partial;        // [blocks, d, 8]
  uint32_t* scal;           // [2, 8] claimed sum and identity offset (K6)
  uint32_t* sponge;         // [FS_SPONGE_WORDS]
  const uint32_t* fixed;    // [2 (d + 1), 8] Lagrange weights and points
  const uint32_t* rows;     // [k + 1, 3, 8] the identity stack
  uint32_t* out;            // [k, d + 2, 8] each round's message and challenge
  uint32_t* ch_mont;        // [8]
  uint32_t* bar;            // the barrier's counter
  int first, rounds;        // round index of the state, rounds to run
};

constexpr int SC_FUSED_UNROLL = 8;
constexpr int SC_FUSED_FOLD_PER_THREAD = 4;

PK_HD int64_t sc_fused_groups(int64_t s) { return (s + SC_WARP - 1) / SC_WARP; }

// The blocks a round of s pairs keeps at work, of the grid's `blocks` of
// `warps` warps: enough warps for one at each t of each 32 pairs of phase
// (a), or enough for the fold at SC_FUSED_FOLD_PER_THREAD elements a thread,
// whichever is more.  The count falls from round to round; a block past it
// has no more work and leaves, so the tail's barriers wait for the few
// blocks that work.
PK_HD int sc_fused_active(int64_t s, long long tables, int blocks, int warps, int degree) {
  int64_t per_block = (int64_t)warps * SC_WARP * SC_FUSED_FOLD_PER_THREAD;
  int64_t want = (tables * s + per_block - 1) / per_block;
  int64_t sums = (sc_fused_groups(s) * degree + warps - 1) / warps;
  if (sums > want) want = sums;
  return want < blocks ? (int)want : blocks;
}

// How phase (a) deals a round's `warps` (all the working blocks' warps)
// out: `slots` sets of 32 pairs side by side, `per_slot` warps each, warp g
// taking slot g / per_slot and t - 1 = g % per_slot, then per_slot more, up
// to d (so with as many warps as d each t has its own warp, and with fewer
// one warp takes several).  A slot's pairs are slot * 32 + lane, then a
// stride of all the slots' pairs.
struct ScDeal {
  int slots, per_slot;
};

PK_HD ScDeal sc_fused_deal(int warps, int degree) {
  int slots = warps / degree > 1 ? warps / degree : 1;
  return ScDeal{slots, warps / slots};
}

// The slots that hold pairs (the others add nothing): phase (a) writes, and
// phase (b) reads, their partial sums only.
PK_HD int sc_fused_live(int64_t s, int slots) {
  int64_t groups = sc_fused_groups(s);
  return groups < slots ? (int)groups : slots;
}

// Phase (a): lane `lane`'s sum of the Tape at t = tm1 + 1 over the pairs of
// `slot`.
template <class Tape>
PK_HD Fe sc_fused_pairs(const uint32_t* src, int64_t s, const ScFused& p, int tm1, int slot,
                        int slots, int lane) {
  return sc_thread_sum<Tape>(src, s, p.consts, p.ids, tm1, (int64_t)slot * SC_WARP + lane,
                             (int64_t)slots * SC_WARP);
}

// Phase (b): thread i of `count`'s share of the partial sums of the `slots`
// at t - 1 = tm1, SC_FUSED_UNROLL loads in flight at a time (in the tail, a
// round's time is these loads' latency, one after another).
template <class F>
PK_HD Fe sc_fused_share(const uint32_t* partial, int slots, int degree, int tm1, int i,
                        int count) {
  Fe acc = fe_zero();
  int u = i;
  for (; u + (SC_FUSED_UNROLL - 1) * count < slots; u += SC_FUSED_UNROLL * count) {
    Fe v[SC_FUSED_UNROLL];
#pragma unroll
    for (int k = 0; k < SC_FUSED_UNROLL; k++)
      v[k] = fe_load(partial + ((int64_t)(u + k * count) * degree + tm1) * 8);
#pragma unroll
    for (int k = 0; k < SC_FUSED_UNROLL; k++) acc = fe_add<F>(acc, v[k]);
  }
  for (; u < slots; u += count)
    acc = fe_add<F>(acc, fe_load(partial + ((int64_t)u * degree + tm1) * 8));
  return acc;
}

// Phase (c): the fold of elements e, e + threads, ... below n_out (K4's
// fold_element), SC_FUSED_FOLD_PER_THREAD of them loaded before any is
// written, so that a thread keeps that many loads in flight.
template <class F>
PK_HD void sc_fused_fold(const uint32_t* src, uint32_t* dst, const Fe& c, int64_t e,
                         int64_t threads, int64_t n_out) {
  constexpr int K = SC_FUSED_FOLD_PER_THREAD;
  for (; e + (K - 1) * threads < n_out; e += K * threads) {
    Fe lo[K], hi[K];
#pragma unroll
    for (int k = 0; k < K; k++) {
      lo[k] = fe_load(src + 2 * (e + k * threads) * 8);
      hi[k] = fe_load(src + (2 * (e + k * threads) + 1) * 8);
    }
#pragma unroll
    for (int k = 0; k < K; k++)
      fe_store(dst + (e + k * threads) * 8,
               fe_add<F>(lo[k], fe_mul<F>(fe_sub<F>(hi[k], lo[k]), c)));
  }
  for (; e < n_out; e += threads) fold_element<F>(e, src, c, dst);
}

// The round's K6 inputs and outputs: rows r and r + 1 of the stack, row r of out.
PK_HD const uint32_t* sc_fused_rows(const ScFused& p, int r) { return p.rows + 24 * r; }

PK_HD uint32_t* sc_fused_out(const ScFused& p, int r, int degree) {
  return p.out + (int64_t)r * (degree + 2) * 8;
}

}  // namespace pk

#ifdef __CUDACC__

namespace pk {

// Blocks 0 .. n - 1 meet here; writes before it are seen after it.
__device__ __forceinline__ void sc_grid_sync(uint32_t* bar, int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t add = blockIdx.x == 0 ? 0x80000000u - (uint32_t)(n - 1) : 1u;
    __threadfence();
    uint32_t old = atomicAdd(bar, add);
    while (((old ^ *(volatile uint32_t*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <class Tape>
__global__ void sc_fused_kernel(ScFused p) {
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  __shared__ FsShared sh;
  __shared__ uint32_t sums[8 * D];
  __shared__ uint32_t red[8 * SC_FUSED_MAX_WARPS];
  const int warp = threadIdx.x / SC_WARP, lane = threadIdx.x % SC_WARP;
  const int warps = blockDim.x / SC_WARP;
  int64_t s = p.s0;
  for (int j = 0; j < p.rounds; j++) {
    const int r = p.first + j;
    const uint32_t* src = j % 2 ? p.b : p.a;
    uint32_t* dst = j % 2 ? p.a : p.b;
    const int active = sc_fused_active(s, p.tables, gridDim.x, warps, D);
    if ((int)blockIdx.x >= active) return;
    const ScDeal deal = sc_fused_deal(active * warps, D);
    const int g = blockIdx.x * warps + warp, slot = g / deal.per_slot;
    const int live = sc_fused_live(s, deal.slots);
    // (a) each warp's partial sums: its slot's pairs at its values of t
    if (slot < live) {
      for (int tm1 = g % deal.per_slot; tm1 < D; tm1 += deal.per_slot) {
        Fe acc = fs_warp_sum<F>(sc_fused_pairs<Tape>(src, s, p, tm1, slot, deal.slots, lane));
        if (lane == 0) fe_store(p.partial + ((int64_t)slot * D + tm1) * 8, acc);
      }
    }
    sc_grid_sync(p.bar, active);
    // (b) the sums and the round message, on block 0
    if (blockIdx.x == 0) {
      for (int tm1 = 0; tm1 < D; tm1++) {
        Fe acc = fs_warp_sum<F>(sc_fused_share<F>(p.partial, live, D, tm1, threadIdx.x,
                                                  blockDim.x));
        if (lane == 0) fe_store(red + 8 * warp, acc);
        __syncthreads();
        if (threadIdx.x == 0) {
          Fe total = fe_load(red);
          for (int w = 1; w < warps; w++) total = fe_add<F>(total, fe_load(red + 8 * w));
          fe_store(sums + 8 * tm1, total);
        }
        __syncthreads();
      }
      if (warp == 0)
        fs_round_warp<F>(lane, sums, p.scal, p.sponge, p.fixed, sc_fused_rows(p, r), D,
                         sc_fused_out(p, r, D), p.ch_mont, p.ids, sh);
    }
    sc_grid_sync(p.bar, active);
    // (c) the fold into the other buffer
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    sc_fused_fold<F>(src, dst, fe_load(p.ch_mont), first, (int64_t)active * blockDim.x,
                     p.tables * s);
    s /= 2;
    if (j + 1 < p.rounds) sc_grid_sync(p.bar, active);
  }
}

template <class Tape>
int sc_fused_run(const ScFused& p, int blocks, int warps, void* stream) {
  if (Tape::DEGREE > FS_MAX_DEGREE || warps < 1 || warps > SC_FUSED_MAX_WARPS) return -1;
  ScFused arg = p;
  void* args[] = {&arg};
  int rc = (int)cudaLaunchCooperativeKernel((const void*)sc_fused_kernel<Tape>, dim3(blocks),
                                            dim3(warps * SC_WARP), args, 0,
                                            (cudaStream_t)stream);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The launch shape: out = warps per block, blocks the card holds at once
// (every one resident, as a cooperative launch needs), registers per
// thread, local memory bytes per thread.  Of the block sizes the registers
// allow, the one that keeps the most warps resident, and of those the
// largest: fewer blocks meet at each barrier, and block 0 has more warps
// for the reduce.
template <class Tape>
int sc_fused_config(int* out) {
  if (Tape::DEGREE > FS_MAX_DEGREE) return -1;
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, sc_fused_kernel<Tape>);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, coop = 0;
  rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc != 0) return rc;
  if (!coop) return -2;
  int most = a.maxThreadsPerBlock / SC_WARP, warps = 0, per_sm = 0;
  if (most > SC_FUSED_MAX_WARPS) most = SC_FUSED_MAX_WARPS;
  for (int w = most; w >= 1; w--) {
    int n = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sc_fused_kernel<Tape>,
                                                            w * SC_WARP, 0);
    if (rc != 0) return rc;
    if (w * n > warps * per_sm) {
      warps = w;
      per_sm = n;
    }
  }
  if (per_sm < 1) return -3;
  out[0] = warps;
  out[1] = per_sm * sms;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace pk

#else  // the host build of the CPU tests

namespace pk {

// The launch's phases one after another: (a) warp by warp and lane by lane,
// (b) each thread's share of the partials, then K6's round twin, (c) each
// thread's elements of the fold.
template <class Tape>
int sc_fused_run(const ScFused& p, int blocks, int warps, void* stream) {
  (void)stream;
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  if (D > FS_MAX_DEGREE || warps < 1 || warps > SC_FUSED_MAX_WARPS) return -1;
  uint32_t sums[8 * D];
  int64_t s = p.s0;
  for (int j = 0; j < p.rounds; j++) {
    const int r = p.first + j;
    const uint32_t* src = j % 2 ? p.b : p.a;
    uint32_t* dst = j % 2 ? p.a : p.b;
    const int active = sc_fused_active(s, p.tables, blocks, warps, D);
    const ScDeal deal = sc_fused_deal(active * warps, D);
    const int live = sc_fused_live(s, deal.slots);
    for (int g = 0; g < active * warps; g++) {
      const int slot = g / deal.per_slot;
      if (slot >= live) continue;
      for (int tm1 = g % deal.per_slot; tm1 < D; tm1 += deal.per_slot) {
        Fe acc = fe_zero();
        for (int lane = 0; lane < SC_WARP; lane++)
          acc = fe_add<F>(acc, sc_fused_pairs<Tape>(src, s, p, tm1, slot, deal.slots, lane));
        fe_store(p.partial + ((int64_t)slot * D + tm1) * 8, acc);
      }
    }
    for (int tm1 = 0; tm1 < D; tm1++) {
      Fe total = fe_zero();
      for (int i = 0; i < warps * SC_WARP; i++)
        total = fe_add<F>(total, sc_fused_share<F>(p.partial, live, D, tm1, i,
                                                   warps * SC_WARP));
      fe_store(sums + 8 * tm1, total);
    }
    fs_round_twin<F>(sums, p.scal, p.sponge, p.fixed, sc_fused_rows(p, r), D,
                     sc_fused_out(p, r, D), p.ch_mont, p.ids);
    const Fe c = fe_load(p.ch_mont);
    const int64_t threads = (int64_t)active * warps * SC_WARP;
    for (int64_t t = 0; t < threads; t++)
      sc_fused_fold<F>(src, dst, c, t, threads, p.tables * s);
    s /= 2;
  }
  return 0;
}

// A small card: 3 resident blocks of 4 warps, so that a few hundred pairs
// already take several turns of the grid stride, and a degree-5 tape's t
// are dealt to warps of two sets of pairs (one in the last rounds).
template <class Tape>
int sc_fused_config(int* out) {
  if (Tape::DEGREE > FS_MAX_DEGREE) return -1;
  out[0] = 4;
  out[1] = 3;
  out[2] = 0;
  out[3] = 0;
  return 0;
}

}  // namespace pk

#endif  // __CUDACC__
