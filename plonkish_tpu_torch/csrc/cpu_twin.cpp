// Host build of the kernels' arithmetic and per-thread bodies, for the CPU
// tests only (tests/test_torch_csrc_cpu.py): g++ compiles field.cuh,
// curve.cuh and the __host__ __device__ parts of msm.cu, sumcheck.cu and
// probe.cu, and each function below runs a kernel's threads one after
// another.  No entry point of the package loads this library.  K3's
// generated kernels have their own host builds (kernels/sumcheck_gen.py).
#include <stdint.h>

#include <vector>

#include "msm.cu"
#include "probe.cu"
#include "sumcheck.cu"

using namespace pk;

template <class F>
static void fe_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out,
                  int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    Fe x = fe_load(a + 8 * i), y = fe_load(b + 8 * i), r;
    switch (op) {
      case 0: r = fe_add<F>(x, y); break;
      case 1: r = fe_sub<F>(x, y); break;
      case 2: r = fe_mul<F>(x, y); break;
      case 3: r = fe_neg<F>(x); break;
      default: r = fe_mul_f32<F>(x, y); break;
    }
    fe_store(out + 8 * i, r);
  }
}

// K5: every thread of the launch, one after another.
template <class F, int V, int E>
static void chain_threads(const uint32_t* a, const uint32_t* b, uint32_t* out,
                          int64_t n, int chain, int64_t stride) {
  for (int64_t tid = 0; tid < stride; tid++)
    for (int64_t base = tid; base < n; base += stride * E)
      chain_pass<F, V, E>(a, b, out, n, base, stride, chain);
}

template <class F, int V>
static int chain_dispatch(const uint32_t* a, const uint32_t* b, uint32_t* out,
                          int64_t n, int chain, int per_thread, int64_t stride) {
  switch (per_thread) {
    case 1: chain_threads<F, V, 1>(a, b, out, n, chain, stride); return 0;
    case 2: chain_threads<F, V, 2>(a, b, out, n, chain, stride); return 0;
    case 4: chain_threads<F, V, 4>(a, b, out, n, chain, stride); return 0;
    default: return -1;
  }
}

extern "C" {

int twin_mont_mul_chain(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        long long n, int chain, int field, int variant,
                        int per_thread, int blocks, int threads, void* stream) {
  (void)stream;
  int64_t stride = (int64_t)blocks * threads;
  if (field == 0 && variant == 0)
    return chain_dispatch<Fr, 0>(a, b, out, n, chain, per_thread, stride);
  if (field == 0 && variant == 1)
    return chain_dispatch<Fr, 1>(a, b, out, n, chain, per_thread, stride);
  if (field == 1 && variant == 0)
    return chain_dispatch<Fq, 0>(a, b, out, n, chain, per_thread, stride);
  if (field == 1 && variant == 1)
    return chain_dispatch<Fq, 1>(a, b, out, n, chain, per_thread, stride);
  return -1;
}

// field: 0 = Fr, 1 = Fq; op: 0 add, 1 sub, 2 mul, 3 neg, 4 mul in float32.
void twin_fe_op(int field, int op, const uint32_t* a, const uint32_t* b,
                uint32_t* out, int64_t n) {
  if (field == 0)
    fe_op<Fr>(op, a, b, out, n);
  else
    fe_op<Fq>(op, a, b, out, n);
}

// p: Jacobian [n, 3, 8]; q: affine [n, 2, 8] with (0, 0) the identity.
void twin_jac_madd(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    Fe x = fe_load(q + 16 * i), y = fe_load(q + 16 * i + 8);
    bool inf = fe_is_zero(x) && fe_is_zero(y);
    jac_store(out + 24 * i, jac_madd<Fq>(jac_load(p + 24 * i), x, y, inf));
  }
}

void twin_jac_add(const uint32_t* p, const uint32_t* q, uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    jac_store(out + 24 * i, jac_add<Fq>(jac_load(p + 24 * i), jac_load(q + 24 * i)));
}

void twin_jac_dbl(const uint32_t* p, uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    jac_store(out + 24 * i, jac_dbl<Fq>(jac_load(p + 24 * i)));
}

// K1: one level, tile by tile; each tile's threads one after another
// between the kernel's barriers.
int twin_msm_bucket_level(const int32_t* keys, const int32_t* aux,
                          const uint32_t* points, long long m, int num_keys,
                          int affine, uint32_t* buckets, int32_t* ck, int32_t* cf,
                          uint32_t* cp, void* stream) {
  (void)stream;
  std::vector<Seg> segs(K1_THREADS);
  std::vector<uint32_t> pf(K1_THREADS * 32);
  for (int64_t tile = 0; tile * K1_TILE < m; tile++) {
    for (int tid = 0; tid < K1_THREADS; tid++) {
      if (affine)
        bucket_walk<true>(tile, tid, keys, aux, points, m, num_keys, buckets,
                          segs.data(), pf.data());
      else
        bucket_walk<false>(tile, tid, keys, aux, points, m, num_keys, buckets,
                           segs.data(), pf.data());
    }
    for (int s = 1; s < K1_THREADS; s <<= 1)
      for (int tid = 0; tid < K1_THREADS; tid++)
        bucket_tree_step(tid, s, segs.data(), buckets, num_keys);
    bucket_tile_root(tile, segs[0], keys, m, num_keys, buckets, ck, cf, cp);
  }
  return 0;
}

// K2: one level, block by block, in the kernel's phases.
int twin_msm_window_level(const uint32_t* in, int level, int n_in, int windows,
                          uint32_t* out, int n_out, void* stream) {
  (void)stream;
  std::vector<Jac> P(2 * K2_THREADS), V(K2_THREADS);
  int log_span = K2_LOG_SEGMENT + level * K2_LOG_THREADS;
  for (int w = 0; w < windows; w++) {
    for (int blk = 0; blk < n_out; blk++) {
      for (int tid = 0; tid < K2_THREADS; tid++) {
        int64_t item = (int64_t)blk * K2_THREADS + tid;
        if (level == 0)
          window_item<true>(w, item, in, n_in, tid, P.data(), V.data());
        else
          window_item<false>(w, item, in, n_in, tid, P.data(), V.data());
      }
      for (int k = 0; k < K2_LOG_THREADS; k++)
        for (int tid = 0; tid < K2_THREADS; tid++)
          suffix_scan_step(tid, 1 << k, P.data() + (k & 1) * K2_THREADS,
                           P.data() + ((k + 1) & 1) * K2_THREADS);
      const Jac* suf = P.data() + (K2_LOG_THREADS & 1) * K2_THREADS;
      for (int tid = 0; tid < K2_THREADS; tid++) window_share(tid, log_span, suf, V.data());
      for (int s = K2_THREADS / 2; s > 0; s >>= 1)
        for (int tid = 0; tid < K2_THREADS; tid++) tree_sum_step(tid, s, V.data());
      uint32_t* o = out + ((int64_t)w * n_out + blk) * 48;
      jac_store(o, suf[0]);
      jac_store(o + 24, V[0]);
    }
  }
  return 0;
}

// K2's combine: every window's doublings, then the tree.
int twin_msm_window_combine(const uint32_t* pv, int windows, int c, uint32_t* out,
                            void* stream) {
  (void)stream;
  if (windows > K2_THREADS) return -1;
  std::vector<Jac> V(K2_THREADS);
  for (int tid = 0; tid < K2_THREADS; tid++) combine_thread(tid, pv, windows, c, V.data());
  for (int s = K2_THREADS / 2; s > 0; s >>= 1)
    for (int tid = 0; tid < K2_THREADS; tid++) tree_sum_step(tid, s, V.data());
  jac_store(out, V[0]);
  return 0;
}

// K4.
int twin_sumcheck_fold(const uint32_t* state, long long n_out,
                       const uint32_t* challenge, uint32_t* out, void* stream) {
  (void)stream;
  Fe c = fe_load(challenge);
  for (long long e = 0; e < n_out; e++) fold_element(e, state, c, out);
  return 0;
}

}  // extern "C"
