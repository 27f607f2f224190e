// MSM kernels for BN254 G1 and Grumpkin G1: K1 bucket sums and K2 window
// sums with their combine into one point, each a template over the curve's
// base field (Fq for BN254, BN254's Fr for Grumpkin; both curves have a = 0).
//
// K1 (bucket_level_kernel) replaces plonkish_tpu/pallas/msm.py::_bucket_kernel
// (msm.py:46).  The TPU has no atomics and its scatters are serial, so there
// every lane keeps private copies of all buckets, started at a random blind
// point so that an incomplete addition can be used, and the host subtracts
// the blind.  Here every (window, point) digit arrives sorted by key
// (window * B + bucket; a zero digit has the sentinel key W * B, which sorts
// last and is skipped), so each bucket is one run of the sorted array, and
// complete mixed additions need no blind.
//   Bound: integer multiply-adds, one mixed addition (11 products) per entry
//   beyond a bucket's first; the entries' 64-byte points are gathered at
//   random indices.
//   Design: a block takes a tile of K1_TILE consecutive entries, 32 per
//   thread.  A thread adds its entries in order and writes a run that lies
//   wholly inside its stretch straight to its bucket; the runs at the ends of
//   the stretches are joined by a segmented tree over the block in shared
//   memory (Seg, seg_merge), which writes every run that ends inside the
//   tile, so each bucket has exactly one writer.  Only a run that crosses the
//   tile's edge leaves it, through a carry array of two slots per tile
//   (first and last key), each flagged as holding a crossing run or not; the
//   same kernel reduces the carry array at the next level.  The number of
//   levels follows from the number of entries alone: no read between the
//   launches, and one bucket holding every entry costs the same as any other
//   input.  The point of the next entry is copied into shared memory with
//   cp.async (a double buffer per thread) while the current addition runs.
//
// K2 (window_level_kernel, window_combine_kernel) replaces ::_reduce_kernel
// (msm.py:119), and takes over the combine that the host did after it.
//   Bound: integer multiply-adds, two full additions per bucket for the
//   running sums, then W * c doublings for the combine.
//   Design: a window is cut into segments of K2_SEGMENT buckets, one per
//   thread, so the windows spread over the whole card (W * B / 16 threads).
//   A thread forms its segment's plain sum P and weighted sum V (weights 0..15
//   within the segment).  Within a block, a suffix scan of P in shared memory
//   gives each segment the sum of the later ones, its share is V plus 16
//   times that (4 doublings), and a tree sums the shares.  The block's (P, V)
//   is an item of span 16 * 128 buckets for the next level, which repeats the
//   same steps until one item per window is left.  The combine kernel doubles
//   window w c * w times (a thread each) and sums the results in a tree: one
//   Jacobian point leaves the card.
//
// Every step that a block takes between two barriers is a __host__
// __device__ function over explicit slot arrays, so the g++ twin
// (csrc/cpu_twin.cpp) runs a block's threads one after another between the
// barriers.
#pragma once

#include "curve.cuh"

namespace pk {

constexpr int K1_THREADS = 128;
constexpr int K1_PER_THREAD = 32;
constexpr int K1_TILE = K1_THREADS * K1_PER_THREAD;
constexpr int K2_THREADS = 128;
constexpr int K2_LOG_THREADS = 7;
constexpr int K2_SEGMENT = 16;
constexpr int K2_LOG_SEGMENT = 4;

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// A stretch of sorted entries: the runs at its two ends.  `uniform` means one
// run covers the whole stretch (its sum is in h, and tk == hk).  A flag is 1
// when the run's sum holds a live entry (level 0: a non-sentinel key; later
// levels: a crossing run), and only such sums are ever written to a bucket.
struct Seg {
  int32_t hk, tk;
  uint32_t hf, tf;
  uint32_t uniform, empty;
  Jac h, t;
};

PK_HD void bucket_emit(uint32_t* buckets, int num_keys, int32_t key,
                       const Jac& sum, uint32_t flag) {
  if (flag && key >= 0 && key < num_keys) jac_store(buckets + (int64_t)key * 24, sum);
}

// The point buffers of K1's threads: two per thread, each four 16-byte
// chunks, chunk k of every thread side by side, so that neighbouring threads
// copy and read neighbouring 16 bytes.  Word offset of chunk k of thread
// tid's buffer buf:
PK_HD int pf_chunk(int buf, int k, int tid) { return ((buf * 4 + k) * K1_THREADS + tid) * 4; }

// Copy one 64-byte affine point into thread tid's buffer buf: cp.async on
// the card, a plain copy in the host build.
PK_HD void pf_point(uint32_t* pf, int buf, int tid, const uint32_t* src) {
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint32_t* dst = pf + pf_chunk(buf, k, tid);
#ifdef __CUDA_ARCH__
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + 4 * k)
                 : "memory");
#else
    for (int j = 0; j < 4; j++) dst[j] = src[4 * k + j];
#endif
  }
}

PK_HD void pf_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until every copy but the most recently committed one has landed.
PK_HD void pf_wait_prev() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// The point in thread tid's buffer buf, 16 bytes at a time.
PK_HD void pf_read(const uint32_t* pf, int buf, int tid, Fe& x, Fe& y) {
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint32_t* q = pf + pf_chunk(buf, k, tid);
    uint32_t* dst = (k < 2 ? x.v : y.v) + 4 * (k & 1);
#ifdef __CUDA_ARCH__
    uint4 w = *reinterpret_cast<const uint4*>(q);
    dst[0] = w.x;
    dst[1] = w.y;
    dst[2] = w.z;
    dst[3] = w.w;
#else
    for (int j = 0; j < 4; j++) dst[j] = q[j];
#endif
  }
}

// Thread `tid` of tile `tile`: entries [lo, hi) in order.  AFFINE (level 0):
// aux[i] = 2 * point + sign, points = the affine basis [N, 2, 8] (identity as
// (0, 0)), live = key below the sentinel.  Otherwise (carry levels): aux[i]
// is the slot's flag and points[i] its Jacobian sum.  Runs wholly inside the
// stretch go to their buckets; the end runs go to segs[tid].  pf holds the
// block's point buffers (pf_chunk).
template <class F, bool AFFINE>
PK_HD void bucket_walk(int64_t tile, int tid, const int32_t* keys, const int32_t* aux,
                       const uint32_t* points, int64_t m, int num_keys,
                       uint32_t* buckets, Seg* segs, uint32_t* pf) {
  Seg& seg = segs[tid];
  int64_t lo = tile * K1_TILE + (int64_t)tid * K1_PER_THREAD;
  int64_t hi = lo + K1_PER_THREAD < m ? lo + K1_PER_THREAD : m;
  seg.empty = lo >= hi ? 1 : 0;
  seg.uniform = 0;
  if (lo >= hi) return;
  int32_t key = keys[lo];
  int32_t a = aux[lo];
  bool live = AFFINE ? key < num_keys : a != 0;
  if constexpr (AFFINE) {
    if (live) pf_point(pf, 0, tid, points + (int64_t)(a >> 1) * 16);
    pf_commit();
  }
  Jac acc = jac_identity();
  uint32_t flag = 0;
  bool first = true;
  for (int64_t i = lo; i < hi; i++) {
    bool more = i + 1 < hi;
    int32_t nkey = more ? keys[i + 1] : key;
    int32_t na = more ? aux[i + 1] : 0;
    bool nlive = more && (AFFINE ? nkey < num_keys : na != 0);
    if constexpr (AFFINE) {
      if (nlive) pf_point(pf, (int)((i + 1 - lo) & 1), tid, points + (int64_t)(na >> 1) * 16);
      pf_commit();
      pf_wait_prev();
    }
    if (live) {
      if constexpr (AFFINE) {
        Fe x, y;
        pf_read(pf, (int)((i - lo) & 1), tid, x, y);
        bool inf = fe_is_zero(x) && fe_is_zero(y);
        if ((a & 1) && !inf) y = fe_neg<F>(y);
        acc = jac_madd<F>(acc, x, y, inf);
      } else {
        acc = jac_add<F>(acc, jac_load(points + i * 24));
      }
      flag = 1;
    }
    if (!more || nkey != key) {  // the run of `key` ends at entry i
      if (first) {
        seg.hk = key;
        seg.tk = key;
        seg.h = acc;
        seg.hf = flag;
        seg.uniform = more ? 0 : 1;
        first = false;
      } else if (more) {
        bucket_emit(buckets, num_keys, key, acc, flag);
      } else {
        seg.tk = key;
        seg.t = acc;
        seg.tf = flag;
      }
      acc = jac_identity();
      flag = 0;
    }
    key = nkey;
    a = na;
    live = nlive;
  }
}

// A <- A followed by B; writes the runs that the join closes.
template <class F>
PK_HD void seg_merge(Seg& A, const Seg& B, uint32_t* buckets, int num_keys) {
  if (B.empty) return;
  if (A.empty) {
    A = B;
    return;
  }
  bool join = A.tk == B.hk;
  Jac joined;
  uint32_t jf = 0;
  if (join) {
    joined = jac_add<F>(A.uniform ? A.h : A.t, B.h);
    jf = (A.uniform ? A.hf : A.tf) | B.hf;
  }
  if (A.uniform && B.uniform) {
    if (join) {
      A.h = joined;
      A.hf = jf;
    } else {
      A.uniform = 0;
      A.tk = B.hk;
      A.t = B.h;
      A.tf = B.hf;
    }
  } else if (A.uniform) {
    if (join) {
      A.h = joined;
      A.hf = jf;
    } else {
      bucket_emit(buckets, num_keys, B.hk, B.h, B.hf);
    }
    A.uniform = 0;
    A.tk = B.tk;
    A.t = B.t;
    A.tf = B.tf;
  } else if (B.uniform) {
    if (join) {
      A.t = joined;
      A.tf = jf;
    } else {
      bucket_emit(buckets, num_keys, A.tk, A.t, A.tf);
      A.tk = B.hk;
      A.t = B.h;
      A.tf = B.hf;
    }
  } else {
    if (join) {
      bucket_emit(buckets, num_keys, A.tk, joined, jf);
    } else {
      bucket_emit(buckets, num_keys, A.tk, A.t, A.tf);
      bucket_emit(buckets, num_keys, B.hk, B.h, B.hf);
    }
    A.tk = B.tk;
    A.t = B.t;
    A.tf = B.tf;
  }
}

// One step of the block's segmented tree (s = 1, 2, 4, ...).
template <class F>
PK_HD void bucket_tree_step(int tid, int s, Seg* segs, uint32_t* buckets, int num_keys) {
  if ((tid & (2 * s - 1)) == 0) seg_merge<F>(segs[tid], segs[tid + s], buckets, num_keys);
}

// Thread 0 after the tree: write the tile's end runs that end inside it, and
// the two carry slots (key, flag, Jacobian sum) of the tile.
PK_HD void bucket_tile_root(int64_t tile, const Seg& r, const int32_t* keys, int64_t m,
                            int num_keys, uint32_t* buckets, int32_t* ck, int32_t* cf,
                            uint32_t* cp) {
  int64_t start = tile * K1_TILE;
  int64_t end = start + K1_TILE < m ? start + K1_TILE : m;
  int32_t left = start > 0 ? keys[start - 1] : -1;
  int32_t right = end < m ? keys[end] : -1;
  bool hcross = r.hk == left || (r.uniform && r.hk == right);
  bool tcross = !r.uniform && r.tk == right;
  if (!hcross) bucket_emit(buckets, num_keys, r.hk, r.h, r.hf);
  if (!r.uniform && !tcross) bucket_emit(buckets, num_keys, r.tk, r.t, r.tf);
  Jac id = jac_identity();
  ck[2 * tile] = r.hk;
  cf[2 * tile] = hcross ? r.hf : 0;
  jac_store(cp + 2 * tile * 24, hcross ? r.h : id);
  ck[2 * tile + 1] = r.tk;
  cf[2 * tile + 1] = tcross ? r.tf : 0;
  jac_store(cp + (2 * tile + 1) * 24, tcross ? r.t : id);
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// Thread `tid`'s item (P, V) of window w.  Level 0: segment `item` of the
// window's n_in buckets ([W, n_in, 3, 8]), P = sum of its buckets, V = sum of
// j * bucket[item * K2_SEGMENT + j].  Later levels: item `item` of the
// previous level's [W, n_in, 2, 3, 8] output (identity past n_in).  Over a
// whole window, V = sum_b b * bucket[b].
template <class F, bool LEAF>
PK_HD void window_item(int w, int64_t item, const uint32_t* in, int n_in, int tid,
                       Jac* P, Jac* V) {
  Jac p = jac_identity();
  Jac v = jac_identity();
  if constexpr (LEAF) {
    const uint32_t* wb = in + (int64_t)w * n_in * 24;
    int64_t base = item * K2_SEGMENT;
    for (int j = K2_SEGMENT - 1; j >= 0; j--) {
      if (base + j < n_in) p = jac_add<F>(p, jac_load(wb + (base + j) * 24));
      if (j > 0) v = jac_add<F>(v, p);  // p is the running sum from j up
    }
  } else {
    if (item < n_in) {
      const uint32_t* src = in + ((int64_t)w * n_in + item) * 48;
      p = jac_load(src);
      v = jac_load(src + 24);
    }
  }
  P[tid] = p;
  V[tid] = v;
}

// One step (d = 1, 2, 4, ...) of the inclusive suffix scan over the block.
template <class F>
PK_HD void suffix_scan_step(int tid, int d, const Jac* src, Jac* dst) {
  dst[tid] = tid + d < K2_THREADS ? jac_add<F>(src[tid], src[tid + d]) : src[tid];
}

// Item tid's share: V + 2^log_span * (the P of the later items of the block).
template <class F>
PK_HD void window_share(int tid, int log_span, const Jac* suf, Jac* V) {
  if (tid + 1 >= K2_THREADS) return;
  Jac later = suf[tid + 1];
  for (int k = 0; k < log_span; k++) later = jac_dbl<F>(later);
  V[tid] = jac_add<F>(V[tid], later);
}

// One step (s = K2_THREADS / 2, ..., 1) of a tree sum over the block.
template <class F>
PK_HD void tree_sum_step(int tid, int s, Jac* V) {
  if (tid < s) V[tid] = jac_add<F>(V[tid], V[tid + s]);
}

// Thread tid of the combine: 2^(c * tid) * window_tid.
template <class F>
PK_HD void combine_thread(int tid, const uint32_t* pv, int windows, int c, Jac* V) {
  Jac v = jac_identity();
  if (tid < windows) {
    v = jac_load(pv + (int64_t)tid * 48 + 24);
    for (int k = 0; k < c * tid; k++) v = jac_dbl<F>(v);
  }
  V[tid] = v;
}

}  // namespace pk

#ifdef __CUDACC__

namespace pk {

template <class F, bool AFFINE>
__global__ void __launch_bounds__(K1_THREADS)
    bucket_level_kernel(const int32_t* keys, const int32_t* aux, const uint32_t* points,
                        int64_t m, int num_keys, uint32_t* buckets, int32_t* ck,
                        int32_t* cf, uint32_t* cp) {
  __shared__ Seg segs[K1_THREADS];
  __shared__ __align__(16) uint32_t pf[AFFINE ? K1_THREADS * 32 : 4];
  int64_t tile = blockIdx.x;
  int tid = threadIdx.x;
  bucket_walk<F, AFFINE>(tile, tid, keys, aux, points, m, num_keys, buckets, segs, pf);
  __syncthreads();
  for (int s = 1; s < K1_THREADS; s <<= 1) {
    bucket_tree_step<F>(tid, s, segs, buckets, num_keys);
    __syncthreads();
  }
  if (tid == 0) bucket_tile_root(tile, segs[0], keys, m, num_keys, buckets, ck, cf, cp);
}

template <class F, bool LEAF>
__global__ void __launch_bounds__(K2_THREADS)
    window_level_kernel(const uint32_t* in, int n_in, int log_span, uint32_t* out,
                        int n_out) {
  __shared__ Jac P[2][K2_THREADS];
  __shared__ Jac V[K2_THREADS];
  int w = blockIdx.y;
  int tid = threadIdx.x;
  int64_t item = (int64_t)blockIdx.x * K2_THREADS + tid;
  window_item<F, LEAF>(w, item, in, n_in, tid, P[0], V);
  __syncthreads();
  for (int k = 0; k < K2_LOG_THREADS; k++) {
    suffix_scan_step<F>(tid, 1 << k, P[k & 1], P[(k + 1) & 1]);
    __syncthreads();
  }
  const Jac* suf = P[K2_LOG_THREADS & 1];
  window_share<F>(tid, log_span, suf, V);
  __syncthreads();
  for (int s = K2_THREADS / 2; s > 0; s >>= 1) {
    tree_sum_step<F>(tid, s, V);
    __syncthreads();
  }
  if (tid == 0) {
    uint32_t* o = out + ((int64_t)w * n_out + blockIdx.x) * 48;
    jac_store(o, suf[0]);
    jac_store(o + 24, V[0]);
  }
}

template <class F>
__global__ void __launch_bounds__(K2_THREADS)
    window_combine_kernel(const uint32_t* pv, int windows, int c, uint32_t* out) {
  __shared__ Jac V[K2_THREADS];
  int tid = threadIdx.x;
  combine_thread<F>(tid, pv, windows, c, V);
  __syncthreads();
  for (int s = K2_THREADS / 2; s > 0; s >>= 1) {
    tree_sum_step<F>(tid, s, V);
    __syncthreads();
  }
  if (tid == 0) jac_store(out, V[0]);
}

template <class F>
int bucket_level(const int32_t* keys, const int32_t* aux, const uint32_t* points,
                 long long m, int num_keys, int affine, uint32_t* buckets, int32_t* ck,
                 int32_t* cf, uint32_t* cp, cudaStream_t st) {
  long long tiles = (m + K1_TILE - 1) / K1_TILE;
  if (affine)
    bucket_level_kernel<F, true><<<(unsigned)tiles, K1_THREADS, 0, st>>>(
        keys, aux, points, m, num_keys, buckets, ck, cf, cp);
  else
    bucket_level_kernel<F, false><<<(unsigned)tiles, K1_THREADS, 0, st>>>(
        keys, aux, points, m, num_keys, buckets, ck, cf, cp);
  return (int)cudaGetLastError();
}

template <class F>
int window_level(const uint32_t* in, int level, int n_in, int windows, uint32_t* out,
                 int n_out, cudaStream_t st) {
  dim3 grid((unsigned)n_out, (unsigned)windows);
  int log_span = K2_LOG_SEGMENT + level * K2_LOG_THREADS;
  if (level == 0)
    window_level_kernel<F, true><<<grid, K2_THREADS, 0, st>>>(in, n_in, log_span, out, n_out);
  else
    window_level_kernel<F, false><<<grid, K2_THREADS, 0, st>>>(in, n_in, log_span, out, n_out);
  return (int)cudaGetLastError();
}

template <class F>
int window_combine(const uint32_t* pv, int windows, int c, uint32_t* out, cudaStream_t st) {
  window_combine_kernel<F><<<1, K2_THREADS, 0, st>>>(pv, windows, c, out);
  return (int)cudaGetLastError();
}

// Grumpkin's launchers, compiled in msm_grumpkin.cu (nvcc builds the two
// curves' kernels in parallel).
int bucket_level_grumpkin(const int32_t* keys, const int32_t* aux, const uint32_t* points,
                          long long m, int num_keys, int affine, uint32_t* buckets,
                          int32_t* ck, int32_t* cf, uint32_t* cp, cudaStream_t st);
int window_level_grumpkin(const uint32_t* in, int level, int n_in, int windows,
                          uint32_t* out, int n_out, cudaStream_t st);
int window_combine_grumpkin(const uint32_t* pv, int windows, int c, uint32_t* out,
                            cudaStream_t st);

}  // namespace pk

#endif  // __CUDACC__
