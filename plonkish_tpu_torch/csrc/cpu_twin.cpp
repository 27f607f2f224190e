// Host build of the kernels' arithmetic and per-thread bodies, for the CPU
// tests only (tests/test_torch_csrc_cpu.py): g++ compiles field.cuh,
// curve.cuh and the __host__ __device__ parts of msm.cu and sumcheck.cu, and
// each function below runs a kernel's threads one after another.  No entry
// point of the package loads this library.
#include <stdint.h>

#include "msm.cu"
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
      default: r = fe_neg<F>(x); break;
    }
    fe_store(out + 8 * i, r);
  }
}

extern "C" {

// field: 0 = Fr, 1 = Fq; op: 0 add, 1 sub, 2 mul, 3 neg.
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

// K1: every thread of one level, in order.
int twin_msm_bucket_level(const int32_t* keys, int n, const int32_t* src,
                          const uint32_t* bases, const uint32_t* partials,
                          int affine, int chunk, int offset, uint32_t* out,
                          uint8_t* flag, void* stream) {
  (void)stream;
  int64_t threads = ((int64_t)n + offset + chunk - 1) / chunk;
  for (int64_t t = 0; t < threads; t++) {
    int64_t start, end;
    bucket_level_range(t, n, chunk, offset, &start, &end);
    bucket_level_thread(start, end, keys, src, bases, partials, affine, out, flag);
  }
  return 0;
}

// K2: per window, every thread's range, then the block's tree.
int twin_msm_window_reduce(const uint32_t* buckets, int num_windows,
                           int num_buckets, int threads, uint32_t* out,
                           void* stream) {
  (void)stream;
  Jac sh[1024];
  if (threads > 1024) return -1;
  for (int w = 0; w < num_windows; w++) {
    for (int tid = 0; tid < threads; tid++) {
      int lo, hi;
      window_range(tid, threads, num_buckets, &lo, &hi);
      sh[tid] = window_thread(buckets + (int64_t)w * num_buckets * 24, lo, hi);
    }
    for (int s = threads / 2; s > 0; s >>= 1)
      for (int tid = 0; tid < s; tid++) sh[tid] = jac_add<Fq>(sh[tid], sh[tid + s]);
    jac_store(out + (int64_t)w * 24, sh[0]);
  }
  return 0;
}

// K3: every pair, summed in order (the sum mod p does not depend on it).
int twin_sumcheck_round(const uint32_t* state, int T, int s,
                        const int32_t* instrs, int n_instr,
                        const uint32_t* consts, int num_regs, int out_reg,
                        int degree, const uint32_t* ids, int blocks,
                        int threads, uint32_t* partial, uint32_t* out,
                        void* stream) {
  (void)blocks, (void)threads, (void)partial, (void)stream;
  if (num_regs > SC_MAX_REGS || T + 1 > SC_MAX_LEAVES || degree > SC_MAX_DEGREE)
    return -1;
  Fe acc[SC_MAX_DEGREE];
  for (int t = 0; t < SC_MAX_DEGREE; t++) acc[t] = fe_zero();
  for (int64_t i = 0; i < s; i++)
    round_pair(i, state, T, s, instrs, n_instr, consts, out_reg, degree, ids, acc);
  for (int t = 0; t < degree; t++) fe_store(out + 8 * t, acc[t]);
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
