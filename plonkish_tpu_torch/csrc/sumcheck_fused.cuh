// K7, the fused sum-check rounds: every round of an Evaluations sum-check
// from a given one to the last, in two launches on one stream with no host
// read between them: the grid rounds (sc_fused_kernel, one cooperative
// launch) while a round's pairs exceed the handover, then the tail
// (sc_tail_kernel, one thread block cluster) for the rest.
//
// Port-only: no Pallas kernel corresponds.  K7 stands for the JAX package's
// fused-round programs, plonkish_tpu/piop/sum_check.py:573
// (_fused_packed_round_jit: a packed round's evaluations, device-FS message
// and fold as one XLA program) and :609 (_fused_tail_scan_jit: every round
// below the handover in one lax.scan).  The per-round path launches K3's
// round and reduce, K6 and K4 for each round, three to four dependent
// launches, most of them far shorter than a launch below 2^12 pairs.  Here
// a kernel loops over the rounds itself, the round index and the pair count
// as run-time data, so one kernel serves every k.
//
// The grid rounds, on a grid whose blocks are all resident (a cooperative
// launch sized by the occupancy of this kernel), with a grid-wide barrier
// between the phases of each round r:
//   (a) the warps sum the Tape over the pairs at t = 1..d (K3's body): the
//       items of 32 neighbouring pairs at one t, dealt in turn over every
//       warp (sc_fused_item), each item's lanes added by shuffles into the
//       warp's d sums in shared memory; each block writes its d partial sums;
//   (b) block 0 adds the partials (each thread a share of the blocks, then
//       the warps' sums), and its warp 0 runs K6's round
//       message on them (fs_warp.cuh, out of line in sc_fused_message so
//       that one warp's code does not set every thread's registers):
//       absorb, squeeze, the challenge, the next sum and identity offset,
//       row r of `out`, the challenge in Montgomery form and the next
//       round's identity rows (`ids`, which phase (a) reads);
//   (c) every block folds every table at the challenge (K4's arithmetic
//       with sc_mul's out-of-line product, a few elements a thread loaded
//       before any is written), out of place into the other of two buffers:
//       the state the launch starts from, then one of half its size,
//       alternately.
// The blocks are as large as the registers allow while keeping the most
// warps resident (sc_fused_config).  A round keeps as many blocks at work as
// its pairs and its fold need (sc_fused_active); a block past it leaves.
// The barrier is a counter in device memory that each working block's
// thread 0 adds to, the flip of its top bit marking the last arrival (the
// arrangement of cooperative_groups' grid sync, for the blocks still at
// work, with the counter passed in: zero before the first launch, and back
// to a zero count after every barrier).  Tables that a block wrote are read
// by other blocks in the next phase, so the Tape's loads are coherent ones
// (sumcheck.cuh sc_load_pair), from an address that depends on the result
// of the barrier before them (sc_grid_sync).
//
// The tail, from the first round whose pairs the cluster's shared memory
// holds (kernels/sumcheck.py tail_plan: `cap` pairs of every table a block,
// the handover cluster * cap): block b of the cluster loads pairs
// [b n, (b + 1) n) of every table into its shared memory, and each round
//   (a) sums its own pairs as the grid does (its items over its warps) and
//       writes its d partial sums into block 0's shared memory;
//   (b) after the cluster's barrier (barrier.cluster), block 0 adds them and
//       its warp 0 runs the round message into its shared memory;
//   (c) after a second barrier every block reads the challenge and the next
//       identity rows from block 0's shared memory and folds its pairs in
//       place: the fold of pairs [a, a + n) is exactly the next round's
//       [a/2, (a + n)/2), so the next round's sums wait only on the block's
//       own __syncthreads.
// Once a round has fewer than two pairs a block, block 0 gathers every
// block's rows through distributed shared memory and runs the last rounds
// alone (a tail that starts so small runs on block 0 from the first round).
// At the end the final tables, the challenge and the identity rows go back
// to device memory.
//
// Bound: in a large round, K3's multiply-adds (and K4's bytes); in the tail,
// the dependent chain of K6's message, one tape evaluation and the barriers.
// Field additions are exact, so the sums agree with the per-round path bit
// for bit, whatever the number of blocks.
//
// The timing build (kernel_ab.py, never the prove path):
// PK_SC_FUSED_TIMING makes thread 0 of block 0 write %globaltimer and
// clock64 at each phase boundary of each round into `times` [round, 8, 2]:
// 0 the round's start, 1 its own sums done, 2 after the first barrier, 3
// after the reduce, 4 after the message, 5 after the second barrier, 6 after
// its fold, 7 after the third barrier (the grid) or the fold's last
// __syncthreads (the tail).
//
// The phases' bodies are __host__ __device__: the CPU tests build the
// generated source with g++, where sc_fused_run runs the grid rounds warp by
// warp on a small card of 3 resident blocks of 4 warps, and sc_tail_run the
// tail on a cluster of 4 blocks of 2 warps with 4 KB of shared memory each
// for the state (tests/test_torch_sumcheck_gen.py).
#pragma once

#include "fs_warp.cuh"
#include "sumcheck.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

namespace pk {

constexpr int SC_FUSED_MAX_WARPS = 32;
constexpr int SC_TAIL_MAX_CLUSTER = 16;
constexpr int SC_FUSED_PHASES = 8;

// What a launch works on (every pointer a device buffer of int32 words).
struct ScFused {
  uint32_t* a;              // the state at the first round [T, 2 s0, 8]; even rounds read it
  uint32_t* b;              // [T, s0, 8]: odd rounds read it (the tail: the final tables)
  long long tables, s0;     // T and the pairs of the first round
  const uint32_t* consts;   // the Tape's constants
  uint32_t* ids;            // [3, 8] this round's identity rows (mul, base, step)
  uint32_t* partial;        // [blocks, d, 8] (the grid)
  uint32_t* scal;           // [2, 8] claimed sum and identity offset (K6)
  uint32_t* sponge;         // [FS_SPONGE_WORDS]
  const uint32_t* fixed;    // [2 (d + 1), 8] Lagrange weights and points
  const uint32_t* rows;     // [k + 1, 3, 8] the identity stack
  uint32_t* out;            // [k, d + 2, 8] each round's message and challenge
  uint32_t* ch_mont;        // [8]
  uint32_t* bar;            // the grid barrier's counter
  unsigned long long* times;  // [rounds, 8, 2] (the timing build only)
  int first, rounds;        // round index of the state, rounds to run
};

constexpr int SC_FUSED_UNROLL = 8;
constexpr int SC_FUSED_FOLD_PER_THREAD = 4;

PK_HD int64_t sc_fused_groups(int64_t s) { return (s + SC_WARP - 1) / SC_WARP; }

// The blocks a round of s pairs keeps at work, of the grid's `blocks` of
// `warps` warps: enough warps for one at each t of each 32 pairs of phase
// (a), or enough for the fold at SC_FUSED_FOLD_PER_THREAD elements a thread,
// whichever is more.  The count falls from round to round; a block past it
// has no more work and leaves, so the barriers wait for the blocks that work.
PK_HD int sc_fused_active(int64_t s, long long tables, int blocks, int warps, int degree) {
  int64_t per_block = (int64_t)warps * SC_WARP * SC_FUSED_FOLD_PER_THREAD;
  int64_t want = (tables * s + per_block - 1) / per_block;
  int64_t sums = (sc_fused_groups(s) * degree + warps - 1) / warps;
  if (sums > want) want = sums;
  return want < blocks ? (int)want : blocks;
}

// Phase (a)'s items: item i is the 32 pairs of group i / d at t - 1 = i % d,
// one pair a lane.  Warp g of W takes items g, g + W, ...: the values of t
// take turns on every warp (their leaves cost t - 1 additions each, so a
// warp kept to one t would finish apart from the others), and the warps
// share the items whatever their number.
PK_HD int64_t sc_fused_items(int64_t s, int degree) { return sc_fused_groups(s) * degree; }

// Lane `lane`'s value of item `item` of the state at `src` (s pairs a table)
// with identity rows `ids`: the Tape at its pair, zero past the last pair.
template <class Tape>
PK_HD Fe sc_fused_item(const uint32_t* src, int64_t s, const uint32_t* consts,
                       const uint32_t* ids, int64_t item, int lane) {
  const int64_t i = item / Tape::DEGREE * SC_WARP + lane;
  return i < s ? Tape::eval(src, s, i, (int)(item % Tape::DEGREE), consts, ids) : fe_zero();
}

// Phase (b): thread i of `count`'s share of the partial sums of `blocks` blocks
// at t - 1 = tm1, SC_FUSED_UNROLL loads in flight at a time.
template <class F>
PK_HD Fe sc_fused_share(const uint32_t* partial, int blocks, int degree, int tm1, int i,
                        int count) {
  Fe acc = fe_zero();
  int u = i;
  for (; u + (SC_FUSED_UNROLL - 1) * count < blocks; u += SC_FUSED_UNROLL * count) {
    Fe v[SC_FUSED_UNROLL];
#pragma unroll
    for (int k = 0; k < SC_FUSED_UNROLL; k++)
      v[k] = fe_load(partial + ((int64_t)(u + k * count) * degree + tm1) * 8);
#pragma unroll
    for (int k = 0; k < SC_FUSED_UNROLL; k++) acc = fe_add<F>(acc, v[k]);
  }
  for (; u < blocks; u += count)
    acc = fe_add<F>(acc, fe_load(partial + ((int64_t)u * degree + tm1) * 8));
  return acc;
}

// Phase (c) of the grid: the fold of elements e, e + threads, ... below
// n_out, SC_FUSED_FOLD_PER_THREAD of them loaded before any is written, so
// that a thread keeps that many loads in flight; the products are sc_mul's
// calls (inlined, four of them at once set the kernel's registers).
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
      fe_store(dst + (e + k * threads) * 8, fold_value<F>(lo[k], hi[k], c));
  }
  for (; e < n_out; e += threads)
    fe_store(dst + e * 8,
             fold_value<F>(fe_load(src + 2 * e * 8), fe_load(src + (2 * e + 1) * 8), c));
}

// The round's K6 inputs and outputs: rows r and r + 1 of the stack, row r of out.
PK_HD const uint32_t* sc_fused_rows(const ScFused& p, int r) { return p.rows + 24 * r; }

PK_HD uint32_t* sc_fused_out(const ScFused& p, int r, int degree) {
  return p.out + (int64_t)r * (degree + 2) * 8;
}

// ---------------------------------------------------------------------------
// The tail's pieces (every index here is the same on the card and in the
// host twin)
// ---------------------------------------------------------------------------

// Words of block 0's partial sums [cluster, d, 8] at the start of the dynamic
// shared memory, rounded to 16 bytes; the block's state follows.
PK_HD int64_t sc_tail_parts_words(int cluster, int degree) {
  return ((int64_t)cluster * degree * 8 + 3) & ~(int64_t)3;
}

// Identity rows for a block whose first pair is i0: base + i0 * mul.
template <class F>
PK_HD void sc_tail_shift_ids(uint32_t* ids, int64_t i0) {
  if (i0) fe_store(ids + 8, sc_identity<F>(ids, i0, 0));
}

// Row `e` of block b's m rows of every table ([T, m, 8] flat) is row
// (e % m) + b m of table e / m of the state [T, M, 8].
PK_HD int64_t sc_tail_row(int64_t e, int64_t m, int64_t M, int b) {
  return (e / m) * M + (int64_t)b * m + e % m;
}

// The gather's first stage moves block 0's own rows (m of each table,
// [T, m, 8]) to their places among M ([T, M, 8]) in place, tables [lo, hi)
// at a time: table t's rows go from t m to t M, and a batch with
// lo * (M / m) >= hi lands above every row it or a lower table reads.
PK_HD int64_t sc_tail_batch_lo(int64_t hi, int64_t ratio) {
  int64_t lo = (hi + ratio - 1) / ratio;
  return lo < 1 ? 1 : lo;
}

}  // namespace pk

#ifdef __CUDACC__

namespace pk {

#ifdef PK_SC_FUSED_TIMING
__device__ __forceinline__ void sc_stamp(unsigned long long* times, int j, int phase) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    times[(j * SC_FUSED_PHASES + phase) * 2] = g;
    times[(j * SC_FUSED_PHASES + phase) * 2 + 1] = (unsigned long long)clock64();
  }
}
#define PK_SC_STAMP(j, phase) sc_stamp(p.times, j, phase)
#else
#define PK_SC_STAMP(j, phase) ((void)0)
#endif

// K6's round message on warp `lane`s, out of line: its registers (the
// sponge's lanes, the Lagrange terms) are its own, not every thread's.
template <class F>
__device__ __noinline__ void sc_fused_message(int lane, const uint32_t* sums, uint32_t* scal,
                                               uint32_t* sponge, const uint32_t* fixed,
                                               const uint32_t* rows, int degree, uint32_t* out,
                                               uint32_t* ch_mont, uint32_t* ids_next,
                                               FsShared& sh) {
  fs_round_warp<F>(lane, sums, scal, sponge, fixed, rows, degree, out, ch_mont, ids_next, sh);
}

// Blocks 0 .. n - 1 meet here; writes before it are seen after it.  Returns
// the result of the block's last barrier, __syncthreads_count(0), which is 0:
// the Tape's loads are asm statements ordered only by their operands
// (sumcheck.cuh sc_load_pair), so K7 adds this value to the state's address,
// and no load of the next round can move above the barrier.  (A memory
// clobber instead cost the vanilla grid kernel 18 registers on an H100.)
__device__ __forceinline__ int sc_grid_sync(uint32_t* bar, int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t add = blockIdx.x == 0 ? 0x80000000u - (uint32_t)(n - 1) : 1u;
    __threadfence();
    uint32_t old = atomicAdd(bar, add);
    while (((old ^ *(volatile uint32_t*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  return __syncthreads_count(0);
}

// Phase (a) on one block: warp w of the block (warp g of W in all) adds the
// warp sum of each of its items (g, g + W, ...) into its d accumulators in
// shared memory `acc` [warps, d, 8]; then thread t - 1 < d adds the block's
// warps' into `out` [d, 8] (device memory, or block 0's shared memory).
template <class Tape>
__device__ __forceinline__ void sc_block_sums(const uint32_t* src, int64_t s,
                                              const uint32_t* consts, const uint32_t* ids,
                                              int64_t g, int64_t W, uint32_t* acc,
                                              uint32_t* out) {
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  const int warp = threadIdx.x / SC_WARP, lane = threadIdx.x % SC_WARP;
  const int warps = blockDim.x / SC_WARP;
  for (int e = threadIdx.x; e < warps * D * 8; e += blockDim.x) acc[e] = 0;
  __syncthreads();
  uint32_t* mine = acc + warp * D * 8;
  const int64_t items = sc_fused_items(s, D);
  for (int64_t it = g; it < items; it += W) {
    const Fe v = fs_warp_sum<F>(sc_fused_item<Tape>(src, s, consts, ids, it, lane));
    if (lane == 0) {
      uint32_t* at = mine + (it % D) * 8;
      fe_store(at, fe_add<F>(fe_load(at), v));
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < D) {
    Fe total = fe_load(acc + threadIdx.x * 8);
    for (int w = 1; w < warps; w++)
      total = fe_add<F>(total, fe_load(acc + (w * D + threadIdx.x) * 8));
    fe_store(out + threadIdx.x * 8, total);
  }
}

// The grid rounds' body; the grid kernel comes in two builds of it below.
template <class Tape>
__device__ __forceinline__ void sc_fused_body(ScFused p) {
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  __shared__ FsShared sh;
  __shared__ uint32_t sums[8 * D];
  __shared__ uint32_t red[8 * SC_FUSED_MAX_WARPS];
  __shared__ uint32_t acc[8 * D * SC_FUSED_MAX_WARPS];
  const int warp = threadIdx.x / SC_WARP, lane = threadIdx.x % SC_WARP;
  const int warps = blockDim.x / SC_WARP;
  int64_t s = p.s0;
  int zero = 0;  // the last barrier's result (sc_grid_sync)
  for (int j = 0; j < p.rounds; j++) {
    const int r = p.first + j;
    const uint32_t* src = (j % 2 ? p.b : p.a) + zero;
    uint32_t* dst = j % 2 ? p.a : p.b;
    const int active = sc_fused_active(s, p.tables, gridDim.x, warps, D);
    if ((int)blockIdx.x >= active) return;
    PK_SC_STAMP(j, 0);
    // (a) each block's partial sums of its warps' items
    sc_block_sums<Tape>(src, s, p.consts, p.ids, (int64_t)blockIdx.x * warps + warp,
                        (int64_t)active * warps, acc, p.partial + (int64_t)blockIdx.x * D * 8);
    PK_SC_STAMP(j, 1);
    sc_grid_sync(p.bar, active);
    PK_SC_STAMP(j, 2);
    // (b) the sums and the round message, on block 0
    if (blockIdx.x == 0) {
      for (int tm1 = 0; tm1 < D; tm1++) {
        Fe part = fs_warp_sum<F>(sc_fused_share<F>(p.partial, active, D, tm1, threadIdx.x,
                                                   blockDim.x));
        if (lane == 0) fe_store(red + 8 * warp, part);
        __syncthreads();
        if (threadIdx.x == 0) {
          Fe total = fe_load(red);
          for (int w = 1; w < warps; w++) total = fe_add<F>(total, fe_load(red + 8 * w));
          fe_store(sums + 8 * tm1, total);
        }
        __syncthreads();
      }
      PK_SC_STAMP(j, 3);
      if (warp == 0)
        sc_fused_message<F>(lane, sums, p.scal, p.sponge, p.fixed, sc_fused_rows(p, r), D,
                            sc_fused_out(p, r, D), p.ch_mont, p.ids, sh);
      PK_SC_STAMP(j, 4);
    }
    sc_grid_sync(p.bar, active);
    PK_SC_STAMP(j, 5);
    // (c) the fold into the other buffer
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    sc_fused_fold<F>(src, dst, fe_load(p.ch_mont), first, (int64_t)active * blockDim.x,
                     p.tables * s);
    PK_SC_STAMP(j, 6);
    s /= 2;
    if (j + 1 < p.rounds) zero = sc_grid_sync(p.bar, active);
    PK_SC_STAMP(j, 7);
  }
}

// The grid kernel's two builds: blocks of at most SC_FUSED_CAP threads
// (ptxas then keeps to 65536 / SC_FUSED_CAP registers, 168 at 384: 12 warps
// an SM, 3 a scheduler) and blocks as large as the registers ptxas takes
// allow.  sc_fused_config takes the capped one where ptxas fits it without
// local memory, else the other.
constexpr int SC_FUSED_CAP = 384;

template <class Tape>
__global__ void __launch_bounds__(SC_FUSED_CAP) sc_fused_kernel_capped(ScFused p) {
  sc_fused_body<Tape>(p);
}

template <class Tape>
__global__ void sc_fused_kernel(ScFused p) {
  sc_fused_body<Tape>(p);
}

template <class Tape>
const void* sc_fused_fn(int capped) {
  return capped ? (const void*)sc_fused_kernel_capped<Tape> : (const void*)sc_fused_kernel<Tape>;
}

template <class Tape>
int sc_fused_run(const ScFused& p, int blocks, int warps, int capped, void* stream) {
  if (Tape::DEGREE > FS_MAX_DEGREE || warps < 1 || warps > SC_FUSED_MAX_WARPS) return -1;
  ScFused arg = p;
  void* args[] = {&arg};
  int rc = (int)cudaLaunchCooperativeKernel(sc_fused_fn<Tape>(capped), dim3(blocks),
                                            dim3(warps * SC_WARP), args, 0,
                                            (cudaStream_t)stream);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The launch shape: out = warps per block, blocks the card holds at once
// (every one resident, as a cooperative launch needs), registers per
// thread, local memory bytes per thread; then 1 where the capped build is
// taken (its block's thread limit in out[5]), else 0 (and 0).  Of the block
// sizes the registers allow, the one that keeps the most warps resident,
// and of those the largest: fewer blocks meet at each barrier, and block 0
// has more warps for the reduce.
template <class Tape>
int sc_fused_config(int* out) {
  if (Tape::DEGREE > FS_MAX_DEGREE) return -1;
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, sc_fused_fn<Tape>(1));
  if (rc != 0) return rc;
  int capped = 1;
  if (a.localSizeBytes != 0) {
    capped = 0;
    rc = (int)cudaFuncGetAttributes(&a, sc_fused_fn<Tape>(0));
    if (rc != 0) return rc;
  }
  const void* fn = sc_fused_fn<Tape>(capped);
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
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, w * SC_WARP, 0);
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
  out[4] = capped;
  out[5] = capped ? SC_FUSED_CAP : 0;
  return 0;
}

// The tail on one cluster (gridDim.x blocks, the cluster's size; 1 when
// block 0 holds the tail's first round alone).  Dynamic shared memory:
// block 0's partial sums [cluster, d, 8], then the block's state.
template <class Tape>
__global__ void sc_tail_kernel(ScFused p) {
  namespace cg = cooperative_groups;
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  extern __shared__ uint4 sc_tail_smem[];
  __shared__ FsShared sh;
  __shared__ uint32_t sums[8 * D];
  __shared__ uint32_t acc[8 * D * SC_FUSED_MAX_WARPS];  // the block's warps' sums
  __shared__ uint32_t ch0[8], ids0[24];  // block 0: the message's challenge and identity rows
  __shared__ uint32_t ch[8], ids[24];    // this block's: ids' base at its first pair
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = gridDim.x, rank = blockIdx.x;
  const int warp = threadIdx.x / SC_WARP, lane = threadIdx.x % SC_WARP;
  const int warps = blockDim.x / SC_WARP, tid = threadIdx.x, nt = blockDim.x;
  uint32_t* parts = reinterpret_cast<uint32_t*>(sc_tail_smem);
  uint32_t* st = parts + sc_tail_parts_words(nb, D);
  const int64_t T = p.tables;
  bool spread = nb > 1;                  // the cluster holds the round's pairs; else block 0
  int64_t M = 2 * p.s0;                  // rows of each table
  int64_t m = spread ? M / nb : M;       // of them in this block
  for (int64_t e = tid; e < T * m; e += nt) {
    const uint4* q = reinterpret_cast<const uint4*>(p.a + sc_tail_row(e, m, M, rank) * 8);
    uint4* d = reinterpret_cast<uint4*>(st + e * 8);
    d[0] = q[0];
    d[1] = q[1];
  }
  if (tid < 24) ids[tid] = p.ids[tid];
  int zero = __syncthreads_count(0);  // the Tape's loads wait on it (sc_grid_sync)
  if (tid == 0) sc_tail_shift_ids<F>(ids, rank * (m / 2));
  // every block of the cluster has started before any reaches into another's
  // shared memory
  if (spread) cluster.sync(); else __syncthreads();
  for (int j = 0; j < p.rounds; j++) {
    const int r = p.first + j;
    const int64_t n = m / 2;  // this block's pairs of each table
    PK_SC_STAMP(j, 0);
    // (a) this block's sums, into block 0's partials
    sc_block_sums<Tape>(st + zero, n, p.consts, ids, warp, warps, acc,
                        (spread ? cluster.map_shared_rank(parts, 0) : parts) + rank * D * 8);
    PK_SC_STAMP(j, 1);
    if (spread) cluster.sync(); else __syncthreads();
    PK_SC_STAMP(j, 2);
    // (b) block 0: the round's sums and message
    if (rank == 0) {
      if (tid < D) {
        Fe total = fe_load(parts + tid * 8);
        for (int b = 1; b < (spread ? nb : 1); b++)
          total = fe_add<F>(total, fe_load(parts + (b * D + tid) * 8));
        fe_store(sums + 8 * tid, total);
      }
      __syncthreads();
      PK_SC_STAMP(j, 3);
      if (warp == 0)
        sc_fused_message<F>(lane, sums, p.scal, p.sponge, p.fixed, sc_fused_rows(p, r), D,
                            sc_fused_out(p, r, D), ch0, ids0, sh);
      PK_SC_STAMP(j, 4);
    }
    if (spread) cluster.sync(); else __syncthreads();
    PK_SC_STAMP(j, 5);
    // (c) the challenge and the next identity rows, then the fold in place:
    // passes of K elements a thread, all read before any is written; a
    // pass writes rows below those that later passes read
    if (tid < 24) {
      const uint32_t* c0 = spread ? cluster.map_shared_rank(ch0, 0) : ch0;
      const uint32_t* i0 = spread ? cluster.map_shared_rank(ids0, 0) : ids0;
      if (tid < 8) ch[tid] = c0[tid];
      ids[tid] = i0[tid];
    }
    __syncthreads();
    const Fe c = fe_load(ch);
    constexpr int K = SC_FUSED_FOLD_PER_THREAD;
    for (int64_t base = 0; base < T * n; base += (int64_t)K * nt) {
      Fe v[K];
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int64_t f = base + (int64_t)k * nt + tid;
        if (f < T * n)
          v[k] = fold_value<F>(fe_load(st + 2 * f * 8), fe_load(st + (2 * f + 1) * 8), c);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int64_t f = base + (int64_t)k * nt + tid;
        if (f < T * n) fe_store(st + f * 8, v[k]);
      }
      __syncthreads();
    }
    PK_SC_STAMP(j, 6);
    M /= 2;
    m /= 2;
    if (spread && M / 2 < 2 * nb && j + 1 < p.rounds) {
      // fewer than two pairs a block: block 0 gathers the next round's state
      // and goes on alone
      cluster.sync();
      if (rank == 0) {
        for (int64_t hi = T; hi > 1;) {
          const int64_t lo = sc_tail_batch_lo(hi, nb);
          for (int64_t e = lo * m + tid; e < hi * m; e += nt) {
            const Fe v = fe_load(st + e * 8);
            fe_store(st + sc_tail_row(e, m, M, 0) * 8, v);
          }
          __syncthreads();
          hi = lo;
        }
        for (int b = 1; b < nb; b++) {
          const uint32_t* peer = cluster.map_shared_rank(st, b);
          for (int64_t e = tid; e < T * m; e += nt)
            fe_store(st + sc_tail_row(e, m, M, b) * 8, fe_load(peer + e * 8));
        }
      }
      cluster.sync();  // every peer's rows are read before it leaves
      if (rank) return;
      spread = false;
      m = M;
    } else if (tid == 0 && spread) {
      sc_tail_shift_ids<F>(ids, rank * (m / 2));
    }
    zero = __syncthreads_count(0);
    PK_SC_STAMP(j, 7);
  }
  // the final tables (each working block its rows), the challenge and the
  // identity rows
  for (int64_t e = tid; e < T * m; e += nt)
    fe_store(p.b + sc_tail_row(e, m, M, spread ? rank : 0) * 8, fe_load(st + e * 8));
  if (rank == 0) {
    if (tid < 8) p.ch_mont[tid] = ch0[tid];
    if (tid < 24) p.ids[tid] = ids0[tid];
  }
  if (spread) cluster.sync();  // block 0's shared memory is read before it leaves
}

template <class Tape>
int sc_tail_run(const ScFused& p, int blocks, int warps, long long smem, void* stream) {
  if (Tape::DEGREE > FS_MAX_DEGREE || warps < 1 || warps > SC_FUSED_MAX_WARPS ||
      blocks < 1 || blocks > SC_TAIL_MAX_CLUSTER)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps * SC_WARP);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rc = (int)cudaLaunchKernelEx(&cfg, sc_tail_kernel<Tape>, p);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The tail's launch shape: out = warps per block (as many as the registers
// allow), the cluster's blocks (16 where the card places a cluster of 16
// with the non-portable size allowed, else 8), the dynamic shared memory a
// block may take, registers per thread, local memory bytes per thread.
// Sets the kernel's attributes the launch needs.
template <class Tape>
int sc_tail_config(int* out) {
  if (Tape::DEGREE > FS_MAX_DEGREE) return -1;
  const void* fn = (const void*)sc_tail_kernel<Tape>;
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, fn);
  int dev = 0, optin = 0;
  if (rc == 0) rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != 0) return rc;
  int dyn = optin - (int)a.sharedSizeBytes;
  rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != 0) return rc;
  int warps = a.maxThreadsPerBlock / SC_WARP;
  if (warps > SC_FUSED_MAX_WARPS) warps = SC_FUSED_MAX_WARPS;
  int cluster = 0;
  for (int c = SC_TAIL_MAX_CLUSTER; c >= 8 && !cluster; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(warps * SC_WARP);
    cfg.dynamicSmemBytes = (size_t)dyn;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    rc = (int)cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (rc != 0) {
      cudaGetLastError();  // a size the card does not place is not an error here
      continue;
    }
    if (n >= 1) cluster = c;
  }
  if (!cluster) return -4;
  out[0] = warps;
  out[1] = cluster;
  out[2] = dyn;
  out[3] = a.numRegs;
  out[4] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace pk

#else  // the host build of the CPU tests

#include <stddef.h>

#include <vector>

namespace pk {

// Phase (a) on one block, its warps (g0, g0 + 1, ... of W in all) one after
// another and each item's lanes one after another (sc_block_sums).
template <class Tape>
void sc_block_sums_twin(const uint32_t* src, int64_t s, const uint32_t* consts,
                        const uint32_t* ids, int64_t g0, int warps, int64_t W, uint32_t* out) {
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  std::vector<Fe> acc((size_t)warps * D, fe_zero());
  const int64_t items = sc_fused_items(s, D);
  for (int w = 0; w < warps; w++)
    for (int64_t it = g0 + w; it < items; it += W) {
      Fe v = fe_zero();
      for (int lane = 0; lane < SC_WARP; lane++)
        v = fe_add<F>(v, sc_fused_item<Tape>(src, s, consts, ids, it, lane));
      acc[w * D + it % D] = fe_add<F>(acc[w * D + it % D], v);
    }
  for (int t = 0; t < D; t++) {
    Fe total = acc[t];
    for (int w = 1; w < warps; w++) total = fe_add<F>(total, acc[w * D + t]);
    fe_store(out + t * 8, total);
  }
}

// The grid rounds' phases one after another: (a) block by block, (b) each
// thread's share of the partials, then K6's round twin, (c) each thread's
// elements of the fold.
template <class Tape>
int sc_fused_run(const ScFused& p, int blocks, int warps, int capped, void* stream) {
  (void)capped, (void)stream;
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
    for (int b = 0; b < active; b++)
      sc_block_sums_twin<Tape>(src, s, p.consts, p.ids, b * warps, warps,
                               (int64_t)active * warps, p.partial + (int64_t)b * D * 8);
    for (int tm1 = 0; tm1 < D; tm1++) {
      Fe total = fe_zero();
      for (int i = 0; i < warps * SC_WARP; i++)
        total = fe_add<F>(total, sc_fused_share<F>(p.partial, active, D, tm1, i,
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
// already take several turns of the warps over the items, and a degree-5
// tape's t take turns on each warp.
template <class Tape>
int sc_fused_config(int* out) {
  if (Tape::DEGREE > FS_MAX_DEGREE) return -1;
  out[0] = 4;
  out[1] = 3;
  out[2] = 0;
  out[3] = 0;
  out[4] = 0;
  out[5] = 0;
  return 0;
}

// The tail's phases on the cluster's blocks one after another, each block's
// shared memory a vector of its own: (a) block by block, warp by warp and
// lane by lane, (b) block 0's sums and K6's round twin, (c) each block's
// fold in passes (every thread's elements read, then written), the gather
// into block 0 in its two stages.
template <class Tape>
int sc_tail_run(const ScFused& p, int blocks, int warps, long long smem, void* stream) {
  (void)stream;
  using F = typename Tape::F;
  constexpr int D = Tape::DEGREE;
  if (D > FS_MAX_DEGREE || warps < 1 || warps > SC_FUSED_MAX_WARPS || blocks < 1 ||
      blocks > SC_TAIL_MAX_CLUSTER)
    return -1;
  const int nb = blocks, nt = warps * SC_WARP;
  const int64_t T = p.tables, pw = sc_tail_parts_words(nb, D);
  std::vector<std::vector<uint32_t>> mem(nb, std::vector<uint32_t>((size_t)smem / 4));
  std::vector<std::vector<uint32_t>> ids(nb, std::vector<uint32_t>(24));
  uint32_t ch0[8], ids0[24], sums[8 * D];
  bool spread = nb > 1;
  int64_t M = 2 * p.s0, m = spread ? M / nb : M;
  if ((pw + T * m * 8) * 4 > smem) return -5;
  for (int b = 0; b < nb; b++) {
    for (int64_t e = 0; e < T * m; e++)
      for (int w = 0; w < 8; w++) mem[b][pw + e * 8 + w] = p.a[sc_tail_row(e, m, M, b) * 8 + w];
    for (int w = 0; w < 24; w++) ids[b][w] = p.ids[w];
    sc_tail_shift_ids<F>(ids[b].data(), b * (m / 2));
  }
  for (int j = 0; j < p.rounds; j++) {
    const int r = p.first + j;
    const int64_t n = m / 2;
    for (int b = 0; b < (spread ? nb : 1); b++)
      sc_block_sums_twin<Tape>(mem[b].data() + pw, n, p.consts, ids[b].data(), 0, warps, warps,
                               mem[0].data() + b * D * 8);
    for (int t = 0; t < D; t++) {
      Fe acc = fe_load(mem[0].data() + t * 8);
      for (int b = 1; b < (spread ? nb : 1); b++)
        acc = fe_add<F>(acc, fe_load(mem[0].data() + (b * D + t) * 8));
      fe_store(sums + 8 * t, acc);
    }
    fs_round_twin<F>(sums, p.scal, p.sponge, p.fixed, sc_fused_rows(p, r), D,
                     sc_fused_out(p, r, D), ch0, ids0);
    const Fe c = fe_load(ch0);
    constexpr int K = SC_FUSED_FOLD_PER_THREAD;
    for (int b = 0; b < (spread ? nb : 1); b++) {
      uint32_t* st = mem[b].data() + pw;
      for (int w = 0; w < 24; w++) ids[b][w] = ids0[w];
      for (int64_t base = 0; base < T * n; base += (int64_t)K * nt) {
        std::vector<Fe> v((size_t)K * nt);
        for (int tid = 0; tid < nt; tid++)
          for (int k = 0; k < K; k++) {
            const int64_t f = base + (int64_t)k * nt + tid;
            if (f < T * n)
              v[k * nt + tid] =
                  fold_value<F>(fe_load(st + 2 * f * 8), fe_load(st + (2 * f + 1) * 8), c);
          }
        for (int tid = 0; tid < nt; tid++)
          for (int k = 0; k < K; k++) {
            const int64_t f = base + (int64_t)k * nt + tid;
            if (f < T * n) fe_store(st + f * 8, v[k * nt + tid]);
          }
      }
    }
    M /= 2;
    m /= 2;
    if (spread && M / 2 < 2 * nb && j + 1 < p.rounds) {
      uint32_t* st = mem[0].data() + pw;
      for (int64_t hi = T; hi > 1;) {
        const int64_t lo = sc_tail_batch_lo(hi, nb);
        // a batch's rows all read before any is written, then written in
        // reverse: the card's threads keep no order within a batch
        std::vector<Fe> moved;
        for (int64_t e = lo * m; e < hi * m; e++) moved.push_back(fe_load(st + e * 8));
        for (int64_t e = hi * m - 1; e >= lo * m; e--)
          fe_store(st + sc_tail_row(e, m, M, 0) * 8, moved[e - lo * m]);
        hi = lo;
      }
      for (int b = 1; b < nb; b++)
        for (int64_t e = 0; e < T * m; e++)
          fe_store(st + sc_tail_row(e, m, M, b) * 8, fe_load(mem[b].data() + pw + e * 8));
      spread = false;
      m = M;
    } else if (spread) {
      for (int b = 1; b < nb; b++) sc_tail_shift_ids<F>(ids[b].data(), b * (m / 2));
    }
  }
  for (int b = 0; b < (spread ? nb : 1); b++)
    for (int64_t e = 0; e < T * m; e++)
      fe_store(p.b + sc_tail_row(e, m, M, b) * 8, fe_load(mem[b].data() + pw + e * 8));
  for (int w = 0; w < 8; w++) p.ch_mont[w] = ch0[w];
  for (int w = 0; w < 24; w++) p.ids[w] = ids0[w];
  return 0;
}

// A small cluster: 4 blocks of 2 warps, with shared memory for 4 KB of state
// a block besides the partial sums, so that the handover and the gather fall
// within a few rounds of a small state.
template <class Tape>
int sc_tail_config(int* out) {
  if (Tape::DEGREE > FS_MAX_DEGREE) return -1;
  out[0] = 2;
  out[1] = 4;
  out[2] = 4096 + (int)sc_tail_parts_words(4, Tape::DEGREE) * 4;
  out[3] = 0;
  out[4] = 0;
  return 0;
}

}  // namespace pk

#endif  // __CUDACC__
