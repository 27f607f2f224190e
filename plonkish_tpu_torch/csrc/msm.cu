// MSM kernels for BN254 G1: K1 bucket sums and K2 window sums.
//
// K1 replaces plonkish_tpu/pallas/msm.py::_bucket_kernel (msm.py:46).  The
// TPU has no atomics and its scatters are serial, so there every lane keeps
// private copies of all buckets, started at a random blind point so that an
// incomplete addition can be used, and the host subtracts the blind.  Here
// the (window, bucket) entries arrive sorted by key (torch.sort), and each
// thread walks CHUNK consecutive entries, adding with complete mixed
// additions and emitting one partial sum at the end of each run of equal
// keys.  The partials of a run that crossed chunk boundaries are added again
// by the next level (Jacobian inputs), until one sum per key is left; the
// chunk alignment alternates between levels so a run split across a
// boundary is always joined.  No blind and no failure probability.
//
// K2 replaces ::_reduce_kernel (msm.py:119): one block per window; each
// thread takes a contiguous range [lo, hi) of buckets, forms the running
// sums sum_{b in range} (b - lo + 1) * B_b plus (lo - 1) * sum B_b, and the
// block adds the threads' results in a shared-memory tree.
//
// Bound: integer multiply-adds (about 11 field products of 128 IMADs per
// mixed addition, one mixed addition per non-zero window digit of every
// scalar); the points are read once per window.
#include "curve.cuh"

namespace pk {

// One K1 thread: entries [start, end) of the sorted key array.  Affine
// level: src[i] = 2 * point + sign, points from `bases` ([N, 2, 8], identity
// as (0, 0)).  Jacobian level: entry i is partials[i] ([n, 3, 8]).
PK_HD void bucket_level_thread(int64_t start, int64_t end, const int32_t* keys,
                               const int32_t* src, const uint32_t* bases,
                               const uint32_t* partials, int affine,
                               uint32_t* out, uint8_t* flag) {
  Jac acc = jac_identity();
  for (int64_t i = start; i < end; i++) {
    if (affine) {
      int32_t s = src[i];
      const uint32_t* b = bases + (int64_t)(s >> 1) * 16;
      Fe x = fe_load(b);
      Fe y = fe_load(b + 8);
      bool inf = fe_is_zero(x) && fe_is_zero(y);
      if ((s & 1) && !inf) y = fe_neg<Fq>(y);
      acc = jac_madd<Fq>(acc, x, y, inf);
    } else {
      acc = jac_add<Fq>(acc, jac_load(partials + i * 24));
    }
    bool last = (i + 1 == end) || (keys[i + 1] != keys[i]);
    flag[i] = last ? 1 : 0;
    if (last) {
      jac_store(out + i * 24, acc);
      acc = jac_identity();
    }
  }
}

// Range of K1 thread `t` at a level with chunk alignment `offset`.
PK_HD void bucket_level_range(int64_t t, int64_t n, int chunk, int offset,
                              int64_t* start, int64_t* end) {
  int64_t s = t * chunk - offset;
  int64_t e = s + chunk;
  *start = s < 0 ? 0 : s;
  *end = e > n ? n : e;
}

// One K2 thread: buckets [lo, hi) of one window -> sum_{b} b * B_b.
PK_HD Jac window_thread(const uint32_t* window_buckets, int lo, int hi) {
  Jac running = jac_identity();
  Jac acc = jac_identity();
  for (int b = hi - 1; b >= lo; b--) {
    running = jac_add<Fq>(running, jac_load(window_buckets + (int64_t)b * 24));
    acc = jac_add<Fq>(acc, running);
  }
  if (lo > 1 && lo < hi) acc = jac_add<Fq>(acc, jac_mul_small<Fq>(running, lo - 1));
  return acc;
}

PK_HD void window_range(int tid, int threads, int num_buckets, int* lo, int* hi) {
  int total = num_buckets - 1;  // bucket 0 is never used
  int per = (total + threads - 1) / threads;
  int l = 1 + tid * per;
  int h = l + per;
  *lo = l > num_buckets ? num_buckets : l;
  *hi = h > num_buckets ? num_buckets : h;
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

__global__ void bucket_level_kernel(const int32_t* keys, int64_t n,
                                    const int32_t* src, const uint32_t* bases,
                                    const uint32_t* partials, int affine,
                                    int chunk, int offset, int64_t threads,
                                    uint32_t* out, uint8_t* flag) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  int64_t start, end;
  bucket_level_range(t, n, chunk, offset, &start, &end);
  bucket_level_thread(start, end, keys, src, bases, partials, affine, out, flag);
}

__global__ void window_reduce_kernel(const uint32_t* buckets, int num_buckets,
                                     uint32_t* out) {
  extern __shared__ uint32_t sh[];  // [blockDim.x][24]
  int w = blockIdx.x;
  int tid = threadIdx.x;
  int lo, hi;
  window_range(tid, blockDim.x, num_buckets, &lo, &hi);
  Jac acc = window_thread(buckets + (int64_t)w * num_buckets * 24, lo, hi);
  jac_store(sh + tid * 24, acc);
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      Jac a = jac_load(sh + tid * 24);
      Jac b = jac_load(sh + (tid + s) * 24);
      jac_store(sh + tid * 24, jac_add<Fq>(a, b));
    }
    __syncthreads();
  }
  if (tid == 0) jac_store(out + (int64_t)w * 24, jac_load(sh));
}

extern "C" int msm_bucket_level(const int32_t* keys, int n, const int32_t* src,
                                const uint32_t* bases, const uint32_t* partials,
                                int affine, int chunk, int offset, uint32_t* out,
                                uint8_t* flag, void* stream) {
  int64_t threads = ((int64_t)n + offset + chunk - 1) / chunk;
  int block = 128;
  int64_t grid = (threads + block - 1) / block;
  bucket_level_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      keys, n, src, bases, partials, affine, chunk, offset, threads, out, flag);
  return (int)cudaGetLastError();
}

extern "C" int msm_window_reduce(const uint32_t* buckets, int num_windows,
                                 int num_buckets, int threads, uint32_t* out,
                                 void* stream) {
  size_t shmem = (size_t)threads * 24 * sizeof(uint32_t);
  window_reduce_kernel<<<num_windows, threads, shmem, (cudaStream_t)stream>>>(
      buckets, num_buckets, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
