// The IPA base fold on Grumpkin G1: out[i] = L[i] + xi * R[i], affine, in
// two launches: the ladder (Jacobian out) and the batch conversion to affine.
//
// No Pallas kernel corresponds to it: plonkish_tpu/pcs/ipa.py:157-160 folds
// the bases with padd(bases_l, scalar_mul_const(bases_r, xi)), a lax.scan of
// 254 doubling-and-add steps over the whole batch (curves/device.py:557-591),
// which XLA fuses.  In eager PyTorch each step is dozens of launches, so the
// fold is a kernel here.
//   Bound: integer multiply-adds (roofline.base_fold_work).
//   Design.  xi is one scalar for the whole round, so the host splits it by
//   the curve's endomorphism phi(x, y) = (beta x, y) = lambda (x, y) into
//   k1 + k2 lambda (about 126 bits each) and recodes k1 + k2 omega, an
//   Eisenstein integer (omega^2 + omega + 1 = 0), in base 2 with digits
//   0, +-omega^j and +-omega^j (1 - omega), j < 3: the one digit congruent to
//   the value mod 4, so every nonzero digit is followed by a zero (a width-2
//   NAF over Z[omega]; about 126 digits, 54 of them nonzero).  Every thread
//   walks that one schedule (FoldSchedule, a kernel parameter), so no warp
//   diverges.  The digit points are phi^j(R) = (beta^j x, y) and phi^j(Q)
//   with Q = R - phi(R), negated by y.  Q is Jacobian (X3, Y3, Z3); on the
//   isomorphic curve y^2 = x^3 + Z3^6 b, (x, y) -> (Z3^2 x, Z3^3 y), Q is the
//   affine (X3, Y3), so every addition of the ladder is mixed (11 products)
//   without an inversion: the formulas of curve.cuh never read b.  The
//   ladder's Z times Z3 maps its result back.  A point costs 16 products of
//   table, about 125 doublings (7) and 53 mixed additions, and the addition
//   of L.  The table keeps x and beta x of each family (the third, beta^2 x,
//   is -(x + beta x)) so that three blocks of 128 threads fit an SM.
//   The result goes out Jacobian (96 bytes a point); the second kernel makes
//   it affine with Montgomery's trick over chunks of FOLD_CHUNK points: 3
//   products a point and one inversion a chunk, then 4 products for (x, y).
//   A chunk is a thread's: a block-wide inversion would stall the ladder's
//   block for its ~380 dependent products.  The identity goes out as (0, 0).
#include "curve.cuh"

namespace pk {

constexpr int FOLD_MAX_DIGITS = 160;
constexpr int FOLD_CHUNK = 32;

// Digit codes: 0, or FOLD_NONZERO | j | FOLD_Q (the Q family) | FOLD_NEG.
constexpr uint32_t FOLD_NONZERO = 16, FOLD_Q = 4, FOLD_NEG = 8;

// A round's schedule, the same for every point: beta in Montgomery form and
// the digits of xi, most significant first (kernels/ipa.py::digits).
struct FoldSchedule {
  uint32_t beta[8];
  int len;
  uint8_t digit[FOLD_MAX_DIGITS];
};

// a if c, else b, word by word (no select of addresses).
PK_HD Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = c ? a.v[w] : b.v[w];
  return r;
}

// a^(p - 2) = a^-1 for a != 0 (0 -> 0), square and multiply over p - 2,
// word by word so that every word of p is a constant.
template <class F>
PK_HD Fe fe_inv(const Fe& a) {
  Fe acc = fe_one<F>();
#pragma unroll
  for (int w = 7; w >= 0; w--) {
    const uint32_t word = F::p(w) - (w == 0 ? 2u : 0u);  // p is odd: no borrow
#pragma unroll 1
    for (int b = 31; b >= 0; b--) {
      acc = fe_sqr<F>(acc);
      if ((word >> b) & 1) acc = fe_mul<F>(acc, a);
    }
  }
  return acc;
}

// Point i of the ladder: jac[i] = L[i] + xi * R[i], Jacobian.  left, right:
// affine [n, 2, 8] (identity (0, 0)); jac: [n, 3, 8].
template <class F>
PK_HD void fold_ladder_point(int64_t i, const uint32_t* left, const uint32_t* right,
                             const FoldSchedule& s, uint32_t* jac) {
  Fe beta = fe_load(s.beta);
  Fe x = fe_load(right + i * 16), y = fe_load(right + i * 16 + 8);
  bool rinf = fe_is_zero(x) && fe_is_zero(y);
  // Q = R + (-phi(R)) from the two affine points (mmadd-2007-bl): h = 0
  // only for the identity, as no point of the curve has x = 0 (-17 is not a
  // square mod p); then u = 1 and Q is never added.
  Fe h = fe_sub<F>(fe_mul<F>(beta, x), x);
  Fe hh = fe_sqr<F>(h);
  Fe i4 = fe_add<F>(hh, hh);
  i4 = fe_add<F>(i4, i4);
  Fe j = fe_mul<F>(h, i4);
  Fe r = fe_add<F>(y, y);
  r = fe_neg<F>(fe_add<F>(r, r));  // 2 (y2 - y1) with y2 = -y
  Fe v = fe_mul<F>(x, i4);
  Fe qx = fe_sub<F>(fe_sub<F>(fe_sqr<F>(r), j), fe_add<F>(v, v));
  Fe yj = fe_mul<F>(y, j);
  Fe qy = fe_sub<F>(fe_mul<F>(r, fe_sub<F>(v, qx)), fe_add<F>(yj, yj));
  bool qinf = fe_is_zero(h);
  Fe u = qinf ? fe_one<F>() : fe_add<F>(h, h);  // Q's Z
  // the points on the curve of u: R' = (u^2 x, u^3 y), Q' = (qx, qy), and
  // L' = (u^2 lx, u^3 ly), which waits in point i's output slot through the
  // ladder, so that it holds no registers; the third x of each family is
  // -(x + beta x), as 1 + beta + beta^2 = 0
  Fe t0, ry;
  bool linf;
  {
    Fe u2 = fe_sqr<F>(u), u3 = fe_mul<F>(u2, u);
    t0 = fe_mul<F>(x, u2);
    ry = fe_mul<F>(y, u3);
    Fe lx = fe_load(left + i * 16), ly = fe_load(left + i * 16 + 8);
    linf = fe_is_zero(lx) && fe_is_zero(ly);
    fe_store(jac + i * 24, fe_mul<F>(lx, u2));
    fe_store(jac + i * 24 + 8, fe_mul<F>(ly, u3));
  }
  Fe t1 = fe_mul<F>(beta, t0), q1 = fe_mul<F>(beta, qx);
  Jac acc = jac_identity();
  for (int k = 0; k < s.len; k++) {
    acc = jac_dbl<F>(acc);
    uint32_t d = s.digit[k];
    if (d) {
      uint32_t e = d & 3;
      bool q = d & FOLD_Q;
      Fe tx = fe_select(q, qx, t0), x1 = fe_select(q, q1, t1);
      if (e == 1) tx = x1;
      if (e == 2) tx = fe_neg<F>(fe_add<F>(tx, x1));
      Fe ty = fe_select(q, qy, ry);
      if (d & FOLD_NEG) ty = fe_neg<F>(ty);
      acc = jac_madd<F>(acc, tx, ty, q ? qinf : rinf);
    }
  }
  acc = jac_madd<F>(acc, fe_load(jac + i * 24), fe_load(jac + i * 24 + 8), linf);
  acc.z = fe_mul<F>(acc.z, u);  // back to the curve of the inputs
  jac_store(jac + i * 24, acc);
}

// Chunk c of the conversion: points c * FOLD_CHUNK .. + FOLD_CHUNK - 1 (those
// below n) of jac [n, 3, 8] made affine into out [n, 2, 8] by one inversion;
// out holds the prefix products between the two passes.
template <class F>
PK_HD void fold_affine_chunk(int64_t c, const uint32_t* jac, int64_t n, uint32_t* out) {
  int64_t lo = c * FOLD_CHUNK, hi = lo + FOLD_CHUNK < n ? lo + FOLD_CHUNK : n;
  Fe acc = fe_one<F>();
  for (int64_t i = lo; i < hi; i++) {
    Fe z = fe_load(jac + i * 24 + 16);
    fe_store(out + i * 16, acc);
    if (!fe_is_zero(z)) acc = fe_mul<F>(acc, z);
  }
  Fe inv = fe_inv<F>(acc);
  for (int64_t i = hi - 1; i >= lo; i--) {
    Fe z = fe_load(jac + i * 24 + 16);
    Fe x = fe_zero(), y = fe_zero();
    if (!fe_is_zero(z)) {
      Fe zi = fe_mul<F>(inv, fe_load(out + i * 16));
      inv = fe_mul<F>(inv, z);
      Fe zi2 = fe_sqr<F>(zi);
      x = fe_mul<F>(fe_load(jac + i * 24), zi2);
      y = fe_mul<F>(fe_load(jac + i * 24 + 8), fe_mul<F>(zi2, zi));
    }
    fe_store(out + i * 16, x);
    fe_store(out + i * 16 + 8, y);
  }
}

// The host entry points' schedule from their arguments; false if it does not fit.
PK_HD bool fold_schedule(const uint32_t* beta, const uint8_t* digits, int len,
                         FoldSchedule& s) {
  if (len < 0 || len > FOLD_MAX_DIGITS) return false;
  for (int w = 0; w < 8; w++) s.beta[w] = beta[w];
  s.len = len;
  for (int k = 0; k < FOLD_MAX_DIGITS; k++) s.digit[k] = k < len ? digits[k] : 0;
  return true;
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

constexpr int FOLD_THREADS = 128;
// Three blocks an SM: ptxas then fits the ladder in 168 registers with a
// few bytes of spills, and it ran faster so than in 206 registers with two
// blocks an SM (and slower with four, in 128 registers).
constexpr int FOLD_MIN_BLOCKS = 3;

template <class F>
__global__ void __launch_bounds__(FOLD_THREADS, FOLD_MIN_BLOCKS)
    ipa_fold_ladder_kernel(const uint32_t* left, const uint32_t* right, int64_t n,
                           const __grid_constant__ FoldSchedule s, uint32_t* jac) {
  int64_t i = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (i < n) fold_ladder_point<F>(i, left, right, s, jac);
}

template <class F>
__global__ void __launch_bounds__(FOLD_THREADS)
    ipa_fold_affine_kernel(const uint32_t* jac, int64_t n, uint32_t* out) {
  int64_t c = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (c * FOLD_CHUNK < n) fold_affine_chunk<F>(c, jac, n, out);
}

// curve: CURVE_GRUMPKIN only (the IPA's curve); any other value is refused.
// beta: 8 Montgomery words, digits: len codes, both in host memory.
extern "C" int ipa_fold_ladder(const uint32_t* left, const uint32_t* right, long long n,
                               const uint32_t* beta, const uint8_t* digits, int len,
                               uint32_t* jac, int curve, void* stream) {
  FoldSchedule s;
  if (curve != CURVE_GRUMPKIN || !fold_schedule(beta, digits, len, s)) return -1;
  if (n == 0) return 0;
  long long grid = (n + FOLD_THREADS - 1) / FOLD_THREADS;
  ipa_fold_ladder_kernel<Fr><<<(unsigned)grid, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      left, right, n, s, jac);
  return (int)cudaGetLastError();
}

extern "C" int ipa_fold_affine(const uint32_t* jac, long long n, uint32_t* out, int curve,
                               void* stream) {
  if (curve != CURVE_GRUMPKIN) return -1;
  if (n == 0) return 0;
  long long chunks = (n + FOLD_CHUNK - 1) / FOLD_CHUNK;
  long long grid = (chunks + FOLD_THREADS - 1) / FOLD_THREADS;
  ipa_fold_affine_kernel<Fr><<<(unsigned)grid, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      jac, n, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
