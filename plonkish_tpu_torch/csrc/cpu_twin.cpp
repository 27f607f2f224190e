// Host build of the kernels' arithmetic and per-thread bodies, for the CPU
// tests only (tests/test_torch_csrc_cpu.py, tests/test_torch_grumpkin.py):
// g++ compiles field.cuh, curve.cuh and the __host__ __device__ parts of
// msm.cu, sumcheck.cu, probe.cu, ipa.cu, fiat_shamir.cu, convert.cu, brakedown.cu and merkle.cu, and
// each function below runs a kernel's threads one after another.  No entry point of the package loads this library.  K3's
// generated kernels have their own host builds (kernels/sumcheck_gen.py).
#include <stdint.h>

#include <vector>

#include "brakedown.cu"
#include "convert.cu"
#include "fiat_shamir.cu"
#include "ipa.cu"
#include "merkle.cu"
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
      case 4: r = fe_mul_f32<F>(x, y); break;
      case 5: r = fe_mul_ptx<F>(x, y); break;
      case 6: r = fe_add_ptx<F>(x, y); break;
      default: r = fe_sub_ptx<F>(x, y); break;
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

// The conversion: every thread of the launch, one after another.
template <class F>
static void convert_threads(const uint32_t* in, uint32_t* out, int64_t n, const Fe& k,
                            int64_t stride) {
  for (int64_t tid = 0; tid < stride; tid++)
    for (int64_t base = tid; base < n; base += stride * CONVERT_PER_THREAD)
      convert_pass<F>(in, out, n, base, stride, k);
}

template <class F>
static void bucket_level_twin(const int32_t* keys, const int32_t* aux,
                              const uint32_t* points, long long m, int num_keys,
                              int affine, uint32_t* buckets, int32_t* ck, int32_t* cf,
                              uint32_t* cp) {
  std::vector<Seg> segs(K1_THREADS);
  std::vector<uint32_t> pf(K1_THREADS * 32);
  for (int64_t tile = 0; tile * K1_TILE < m; tile++) {
    for (int tid = 0; tid < K1_THREADS; tid++) {
      if (affine)
        bucket_walk<F, true>(tile, tid, keys, aux, points, m, num_keys, buckets,
                             segs.data(), pf.data());
      else
        bucket_walk<F, false>(tile, tid, keys, aux, points, m, num_keys, buckets,
                              segs.data(), pf.data());
    }
    for (int s = 1; s < K1_THREADS; s <<= 1)
      for (int tid = 0; tid < K1_THREADS; tid++)
        bucket_tree_step<F>(tid, s, segs.data(), buckets, num_keys);
    bucket_tile_root(tile, segs[0], keys, m, num_keys, buckets, ck, cf, cp);
  }
}

template <class F>
static void window_level_twin(const uint32_t* in, int level, int n_in, int windows,
                              uint32_t* out, int n_out) {
  std::vector<Jac> P(2 * K2_THREADS), V(K2_THREADS);
  int log_span = K2_LOG_SEGMENT + level * K2_LOG_THREADS;
  for (int w = 0; w < windows; w++) {
    for (int blk = 0; blk < n_out; blk++) {
      for (int tid = 0; tid < K2_THREADS; tid++) {
        int64_t item = (int64_t)blk * K2_THREADS + tid;
        if (level == 0)
          window_item<F, true>(w, item, in, n_in, tid, P.data(), V.data());
        else
          window_item<F, false>(w, item, in, n_in, tid, P.data(), V.data());
      }
      for (int k = 0; k < K2_LOG_THREADS; k++)
        for (int tid = 0; tid < K2_THREADS; tid++)
          suffix_scan_step<F>(tid, 1 << k, P.data() + (k & 1) * K2_THREADS,
                              P.data() + ((k + 1) & 1) * K2_THREADS);
      const Jac* suf = P.data() + (K2_LOG_THREADS & 1) * K2_THREADS;
      for (int tid = 0; tid < K2_THREADS; tid++) window_share<F>(tid, log_span, suf, V.data());
      for (int s = K2_THREADS / 2; s > 0; s >>= 1)
        for (int tid = 0; tid < K2_THREADS; tid++) tree_sum_step<F>(tid, s, V.data());
      uint32_t* o = out + ((int64_t)w * n_out + blk) * 48;
      jac_store(o, suf[0]);
      jac_store(o + 24, V[0]);
    }
  }
}

template <class F>
static void window_combine_twin(const uint32_t* pv, int windows, int c, uint32_t* out) {
  std::vector<Jac> V(K2_THREADS);
  for (int tid = 0; tid < K2_THREADS; tid++) combine_thread<F>(tid, pv, windows, c, V.data());
  for (int s = K2_THREADS / 2; s > 0; s >>= 1)
    for (int tid = 0; tid < K2_THREADS; tid++) tree_sum_step<F>(tid, s, V.data());
  jac_store(out, V[0]);
}

// K6: the lanes of the warp one after another between its steps (the
// Evaluations round's twin, fs_round_twin, is fs_warp.cuh's).
template <class F>
static void fs_coeff_twin(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                          const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont) {
  FsShared sh;
  Fe c0, c1, c2;
  fs_coeff_message<F>(v, scal, c0_base, c0, c1, c2);
  for (int t = 0; t < 3; t++) fs_coeff_prepare<F>(t, c0, c1, c2, out, sh);
  Fe ch = fs_squeeze_twin<F>(sponge, 12, sh);
  Fe c = fe_to_mont<F>(ch);
  for (int lane = 0; lane < 32; lane++)
    fs_coeff_finish<F>(lane, 32, c0, c1, c2, ch, c, scal, sponge, out, ch_mont, sh);
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
  if (field == 0 && variant == 2)
    return chain_dispatch<Fr, 2>(a, b, out, n, chain, per_thread, stride);
  if (field == 1 && variant == 2)
    return chain_dispatch<Fq, 2>(a, b, out, n, chain, per_thread, stride);
  return -1;
}

// The conversion's launch (csrc/convert.cu field_convert), same arguments.
int twin_field_convert(const uint32_t* in, uint32_t* out, long long n, const uint32_t* k,
                       int field, int blocks, int threads, void* stream) {
  (void)stream;
  if (n < 0 || blocks <= 0 || threads <= 0) return -1;
  int64_t stride = (int64_t)blocks * threads;
  if (field == 0)
    convert_threads<Fr>(in, out, n, fe_load(k), stride);
  else if (field == 1)
    convert_threads<Fq>(in, out, n, fe_load(k), stride);
  else
    return -1;
  return 0;
}

// field: 0 = Fr, 1 = Fq; op: 0 add, 1 sub, 2 mul, 3 neg, 4 mul in float32, 5 mul, 6 add
// and 7 sub in PTX carry chains (field_ptx.cuh's steps, the carries in a variable).
void twin_fe_op(int field, int op, const uint32_t* a, const uint32_t* b,
                uint32_t* out, int64_t n) {
  if (field == 0)
    fe_op<Fr>(op, a, b, out, n);
  else
    fe_op<Fq>(op, a, b, out, n);
}

// curve: CURVE_BN254 or CURVE_GRUMPKIN; op: 0 madd, 1 add, 2 dbl.  p: Jacobian
// [n, 3, 8]; q: affine [n, 2, 8] with (0, 0) the identity for madd, Jacobian
// for add, unread for dbl.
int twin_jac_op(int curve, int op, const uint32_t* p, const uint32_t* q, uint32_t* out,
                int64_t n) {
  if (curve != CURVE_BN254 && curve != CURVE_GRUMPKIN) return -1;
  for (int64_t i = 0; i < n; i++) {
    Jac a = jac_load(p + 24 * i), r;
    if (op == 0) {
      Fe x = fe_load(q + 16 * i), y = fe_load(q + 16 * i + 8);
      bool inf = fe_is_zero(x) && fe_is_zero(y);
      r = curve == CURVE_BN254 ? jac_madd<Fq>(a, x, y, inf) : jac_madd<Fr>(a, x, y, inf);
    } else if (op == 1) {
      Jac b = jac_load(q + 24 * i);
      r = curve == CURVE_BN254 ? jac_add<Fq>(a, b) : jac_add<Fr>(a, b);
    } else {
      r = curve == CURVE_BN254 ? jac_dbl<Fq>(a) : jac_dbl<Fr>(a);
    }
    jac_store(out + 24 * i, r);
  }
  return 0;
}

// K1: one level, tile by tile; each tile's threads one after another
// between the kernel's barriers.
int twin_msm_bucket_level(const int32_t* keys, const int32_t* aux,
                          const uint32_t* points, long long m, int num_keys,
                          int affine, uint32_t* buckets, int32_t* ck, int32_t* cf,
                          uint32_t* cp, int curve, void* stream) {
  (void)stream;
  if (curve == CURVE_BN254)
    bucket_level_twin<Fq>(keys, aux, points, m, num_keys, affine, buckets, ck, cf, cp);
  else if (curve == CURVE_GRUMPKIN)
    bucket_level_twin<Fr>(keys, aux, points, m, num_keys, affine, buckets, ck, cf, cp);
  else
    return -1;
  return 0;
}

// K2: one level, block by block, in the kernel's phases.
int twin_msm_window_level(const uint32_t* in, int level, int n_in, int windows,
                          uint32_t* out, int n_out, int curve, void* stream) {
  (void)stream;
  if (curve == CURVE_BN254)
    window_level_twin<Fq>(in, level, n_in, windows, out, n_out);
  else if (curve == CURVE_GRUMPKIN)
    window_level_twin<Fr>(in, level, n_in, windows, out, n_out);
  else
    return -1;
  return 0;
}

// K2's combine: every window's doublings, then the tree.
int twin_msm_window_combine(const uint32_t* pv, int windows, int c, uint32_t* out,
                            int curve, void* stream) {
  (void)stream;
  if (windows > K2_THREADS) return -1;
  if (curve == CURVE_BN254)
    window_combine_twin<Fq>(pv, windows, c, out);
  else if (curve == CURVE_GRUMPKIN)
    window_combine_twin<Fr>(pv, windows, c, out);
  else
    return -1;
  return 0;
}

// K4; field: 0 = Fr, 1 = Fq.
int twin_sumcheck_fold(const uint32_t* state, long long n_out,
                       const uint32_t* challenge, uint32_t* out, int field, void* stream) {
  (void)stream;
  Fe c = fe_load(challenge);
  for (long long e = 0; e < n_out; e++) {
    if (field == 0)
      fold_element<Fr>(e, state, c, out);
    else if (field == 1)
      fold_element<Fq>(e, state, c, out);
    else
      return -1;
  }
  return 0;
}

// K6, both rounds.
int twin_fs_round(const uint32_t* sums, uint32_t* scal, uint32_t* sponge, const uint32_t* fixed,
                  const uint32_t* rows, int degree, uint32_t* out, uint32_t* ch_mont,
                  uint32_t* ids_next, int field, void* stream) {
  (void)stream;
  if (degree < 1 || degree > FS_MAX_DEGREE) return -1;
  if (field == 0)
    fs_round_twin<Fr>(sums, scal, sponge, fixed, rows, degree, out, ch_mont, ids_next);
  else if (field == 1)
    fs_round_twin<Fq>(sums, scal, sponge, fixed, rows, degree, out, ch_mont, ids_next);
  else
    return -1;
  return 0;
}

int twin_fs_coeff(const uint32_t* v, uint32_t* scal, uint32_t* sponge, const uint32_t* c0_base,
                  uint32_t* out, uint32_t* ch_mont, int field, void* stream) {
  (void)stream;
  if (field == 0)
    fs_coeff_twin<Fr>(v, scal, sponge, c0_base, out, ch_mont);
  else if (field == 1)
    fs_coeff_twin<Fq>(v, scal, sponge, c0_base, out, ch_mont);
  else
    return -1;
  return 0;
}

// The IPA base fold's two kernels (Grumpkin only, as on the card): the
// ladder point by point, the affine conversion chunk by chunk.
int twin_ipa_fold_ladder(const uint32_t* left, const uint32_t* right, long long n,
                         const uint32_t* beta, const uint8_t* digits, int len, uint32_t* jac,
                         int curve, void* stream) {
  (void)stream;
  FoldSchedule s;
  if (curve != CURVE_GRUMPKIN || !fold_schedule(beta, digits, len, s)) return -1;
  for (long long i = 0; i < n; i++) fold_ladder_point<Fr>(i, left, right, s, jac);
  return 0;
}

int twin_ipa_fold_affine(const uint32_t* jac, long long n, uint32_t* out, int curve,
                         void* stream) {
  (void)stream;
  if (curve != CURVE_GRUMPKIN) return -1;
  for (long long c = 0; c * FOLD_CHUNK < n; c++) fold_affine_chunk<Fr>(c, jac, n, out);
  return 0;
}

// brakedown.cu brakedown_dot, same arguments.
int twin_brakedown_dot(const uint32_t* in, long long in_sb, long long in_si, uint32_t* out,
                       long long out_sb, long long out_sj, const int32_t* offsets,
                       const int32_t* index, const uint32_t* coeff, long long m, int rows,
                       int field, int threads, void* stream) {
  (void)stream;
  if (m < 0 || rows <= 0 || threads <= 0 || (field != 0 && field != 1)) return -1;
  for (int64_t t = 0; t < m * rows; t++) {
    if (field == 0)
      bd_dot_item<Fr>(t, rows, in, in_sb, in_si, out, out_sb, out_sj, offsets, index, coeff);
    else
      bd_dot_item<Fq>(t, rows, in, in_sb, in_si, out, out_sb, out_sj, offsets, index, coeff);
  }
  return 0;
}

// merkle.cu keccak_messages, same arguments.
int twin_keccak_messages(const uint64_t* words, int lanes, long long n, long long width,
                         uint64_t* out, int threads, void* stream) {
  (void)stream;
  if (lanes < 0 || n < 0 || width < n || threads <= 0) return -1;
  for (int64_t i = 0; i < width; i++) keccak_message_item(i, words, lanes, n, out);
  return 0;
}

}  // extern "C"
