// The IPA base fold on Grumpkin G1: out[i] = L[i] + xi * R[i], affine.
//
// No Pallas kernel corresponds to it: plonkish_tpu/pcs/ipa.py:157-160 folds
// the bases with padd(bases_l, scalar_mul_const(bases_r, xi)), a lax.scan of
// 254 doubling-and-add steps over the whole batch (curves/device.py:557-591),
// which XLA fuses.  In eager PyTorch each step is dozens of launches, so the
// fold is a kernel here.
//   Bound: integer multiply-adds.  Per point about 253 doublings (7 products
//   each), one mixed addition per set bit of xi (11 products), the addition
//   of L and an inversion by Fermat (253 squarings and about 127 products).
//   Design: one thread per point runs a double-and-add over xi's bits, most
//   significant first.  xi is the same in every thread, so the branch on a
//   bit never diverges.  L and R are affine (the form K1 reads), so every
//   addition is a mixed one.  The result is made affine in the same thread:
//   the inversion costs about an eighth of the ladder, and the output feeds
//   the next round's MSM (K1) directly, without a batch inversion in torch.
//   The identity comes out as (0, 0).
#include "curve.cuh"

namespace pk {

// a^(p - 2) = a^-1 for a != 0 (0 -> 0), square and multiply over p - 2.
template <class F>
PK_HD Fe fe_inv(const Fe& a) {
  Fe acc = fe_one<F>();
  for (int b = 255; b >= 0; b--) {
    uint32_t word = F::p(b >> 5) - (b < 32 ? 2u : 0u);  // p is odd: no borrow
    acc = fe_sqr<F>(acc);
    if ((word >> (b & 31)) & 1) acc = fe_mul<F>(acc, a);
  }
  return acc;
}

// Point i of the fold.  left, right: affine [n, 2, 8] (identity (0, 0));
// xi: the scalar's 8 canonical words, bits below nbits; out: affine [n, 2, 8].
template <class F>
PK_HD void base_fold_point(int64_t i, const uint32_t* left, const uint32_t* right,
                           const uint32_t* xi, int nbits, uint32_t* out) {
  Fe rx = fe_load(right + i * 16), ry = fe_load(right + i * 16 + 8);
  bool rinf = fe_is_zero(rx) && fe_is_zero(ry);
  Jac acc = jac_identity();
  for (int b = nbits - 1; b >= 0; b--) {
    acc = jac_dbl<F>(acc);
    if ((xi[b >> 5] >> (b & 31)) & 1) acc = jac_madd<F>(acc, rx, ry, rinf);
  }
  Fe lx = fe_load(left + i * 16), ly = fe_load(left + i * 16 + 8);
  acc = jac_madd<F>(acc, lx, ly, fe_is_zero(lx) && fe_is_zero(ly));
  Fe x = fe_zero(), y = fe_zero();
  if (!jac_is_identity(acc)) {
    Fe zi = fe_inv<F>(acc.z);
    Fe zi2 = fe_sqr<F>(zi);
    x = fe_mul<F>(acc.x, zi2);
    y = fe_mul<F>(acc.y, fe_mul<F>(zi2, zi));
  }
  fe_store(out + i * 16, x);
  fe_store(out + i * 16 + 8, y);
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

constexpr int FOLD_THREADS = 128;

template <class F>
__global__ void __launch_bounds__(FOLD_THREADS)
    ipa_base_fold_kernel(const uint32_t* left, const uint32_t* right, int64_t n,
                         const uint32_t* xi, int nbits, uint32_t* out) {
  int64_t i = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t k[8];
#pragma unroll
  for (int w = 0; w < 8; w++) k[w] = __ldg(xi + w);
  base_fold_point<F>(i, left, right, k, nbits, out);
}

// curve: CURVE_GRUMPKIN only (the IPA's curve); any other value is refused.
extern "C" int ipa_base_fold(const uint32_t* left, const uint32_t* right, long long n,
                             const uint32_t* xi, int nbits, uint32_t* out, int curve,
                             void* stream) {
  if (curve != CURVE_GRUMPKIN || nbits < 0 || nbits > 256) return -1;
  if (n == 0) return 0;
  long long grid = (n + FOLD_THREADS - 1) / FOLD_THREADS;
  ipa_base_fold_kernel<Fr><<<(unsigned)grid, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      left, right, n, xi, nbits, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
