// The conversion between Montgomery and canonical form: out[i] = k * x[i] *
// R^-1 mod p, one Montgomery product a element by a constant k below p.
// k = 1 takes a Montgomery value out of the form (x R -> x), k = R^2 mod p
// takes a canonical one into it (x -> x R); limb.from_mont and limb.to_mont
// on a CUDA tensor are this one kernel with the one constant or the other.
//
// The product is fe_mul_ptx (field_ptx.cuh) with k as its first operand,
// whose limbs it keeps whole, and x as the second, which it takes a word a
// step: the running sum stays below 2p for any x below 2^256 when k < p, so
// a digest that is not reduced (pcs/ipa.py's hash to the curve) comes out
// reduced, as it does from the plain CIOS of fields/limb.py, which takes x a
// digit a step against the whole constant.
//
// The work is 32 bytes in and 32 out for 256 multiply-adds an element, about
// as many microseconds of bytes as of products at 2^20 on the H100, so the
// loads must be in flight while the products run: each thread holds E
// elements of a grid-stride loop at once, every element loaded as two 16-byte
// vectors before the first product (a warp's load covers 1 KiB contiguous).
#include "field_ptx.cuh"

namespace pk {

constexpr int CONVERT_PER_THREAD = 4;  // E: elements a thread holds in flight

PK_HD Fe convert_load(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
#else
  return fe_load(p);
#endif
}

PK_HD void convert_store(uint32_t* p, const Fe& a) {
#ifdef __CUDA_ARCH__
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
#else
  fe_store(p, a);
#endif
}

// One thread's pass: elements base, base + stride, ... (E of them, those < n).
template <class F>
PK_HD void convert_pass(const uint32_t* in, uint32_t* out, int64_t n, int64_t base,
                        int64_t stride, const Fe& k) {
  constexpr int E = CONVERT_PER_THREAD;
  Fe x[E];
#pragma unroll
  for (int e = 0; e < E; e++) {
    int64_t i = base + e * stride;
    x[e] = i < n ? convert_load(in + 8 * i) : fe_zero();
  }
#pragma unroll
  for (int e = 0; e < E; e++) {
    int64_t i = base + e * stride;
    if (i < n) convert_store(out + 8 * i, fe_mul_ptx<F>(k, x[e]));
  }
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

template <class F>
__global__ void field_convert_kernel(const uint32_t* in, uint32_t* out, int64_t n, Fe k) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; base < n;
       base += stride * CONVERT_PER_THREAD)
    convert_pass<F>(in, out, n, base, stride, k);
}

// in, out: int32[n, 8], 16-byte aligned; k: the constant's eight limbs, in
// host memory; field: 0 = Fr, 1 = Fq.  Enqueues one launch on `stream` (none
// for n = 0) and returns 0, a CUDA error code, or -1 for a field or launch
// shape the kernel is not built for.
extern "C" int field_convert(const uint32_t* in, uint32_t* out, long long n, const uint32_t* k,
                             int field, int blocks, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || blocks <= 0 || threads <= 0) return -1;
  if (n == 0) return 0;
  Fe c = fe_load(k);
  if (field == 0)
    field_convert_kernel<Fr><<<blocks, threads, 0, st>>>(in, out, n, c);
  else if (field == 1)
    field_convert_kernel<Fq><<<blocks, threads, 0, st>>>(in, out, n, c);
  else
    return -1;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
