// K5: the mont_mul chain probe.
//
// Replaces scripts/validate_pallas_tpu.py::_chain_kernel (:253, launched from
// check_f32_mul): acc = a; repeat `chain` times acc = mul(acc, b), elementwise,
// so out[i] = a[i] * b[i]^chain * R^-chain mod p.  `mul` is the integer CIOS
// product fe_mul (variant 0) or the float32 byte-digit product fe_mul_f32
// (variant 1) of field.cuh, or the product in PTX carry chains fe_mul_ptx
// (variant 2, field_ptx.cuh), the multipliers whose rates the probe
// compares and whose outputs must be equal.
//
// The Pallas kernel runs a grid of 64 steps over one resident block of
// 512 x 128 elements; here the same work is more elements (the default is
// 64 * 512 * 128 = 2^22), each thread taking E elements per pass of a
// grid-stride loop.  Elements are int32[n, 8] limbs, the port's layout.  The
// E chains of a thread are independent, which gives the multiply pipe work
// while one chain waits on its carries.
//
// Bound: at chain = 16 a field element is read twice and written once (96 B)
// for 16 products of 256 multiply-adds, about 8x over the byte bound at the
// card's rates, so the time is a compute rate.  That rate, products per
// second, is what the roofline of the other kernels is read against.
#include "field_ptx.cuh"

namespace pk {

template <class F, int V>
PK_HD Fe probe_mul(const Fe& x, const Fe& y) {
  if constexpr (V == 0)
    return fe_mul<F>(x, y);
  else if constexpr (V == 1)
    return fe_mul_f32<F>(x, y);
  else
    return fe_mul_ptx<F>(x, y);
}

// One thread's pass: elements base, base + stride, ... (E of them, those < n).
template <class F, int V, int E>
PK_HD void chain_pass(const uint32_t* a, const uint32_t* b, uint32_t* out,
                      int64_t n, int64_t base, int64_t stride, int chain) {
  Fe acc[E], y[E];
#pragma unroll
  for (int e = 0; e < E; e++) {
    int64_t i = base + e * stride;
    acc[e] = i < n ? fe_load(a + 8 * i) : fe_zero();
    y[e] = i < n ? fe_load(b + 8 * i) : fe_zero();
  }
#pragma unroll 1
  for (int c = 0; c < chain; c++) {
#pragma unroll
    for (int e = 0; e < E; e++) acc[e] = probe_mul<F, V>(acc[e], y[e]);
  }
#pragma unroll
  for (int e = 0; e < E; e++) {
    int64_t i = base + e * stride;
    if (i < n) fe_store(out + 8 * i, acc[e]);
  }
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

template <class F, int V, int E>
__global__ void mont_mul_chain_kernel(const uint32_t* a, const uint32_t* b,
                                      uint32_t* out, int64_t n, int chain) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; base < n;
       base += stride * E)
    chain_pass<F, V, E>(a, b, out, n, base, stride, chain);
}

template <class F, int V>
static int launch_chain(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        int64_t n, int chain, int per_thread, int blocks,
                        int threads, cudaStream_t st) {
  switch (per_thread) {
    case 1: mont_mul_chain_kernel<F, V, 1><<<blocks, threads, 0, st>>>(a, b, out, n, chain); break;
    case 2: mont_mul_chain_kernel<F, V, 2><<<blocks, threads, 0, st>>>(a, b, out, n, chain); break;
    case 4: mont_mul_chain_kernel<F, V, 4><<<blocks, threads, 0, st>>>(a, b, out, n, chain); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// The PTX sum and difference (field_ptx.cuh, the tape's in K3 and K7) beside
// field.cuh's, for chip_smoke.py's check on the card: out[i] = a + b, a + b,
// a - b, a - b, -a, -a, each pair the PTX one then field.cuh's.
template <class F>
__global__ void field_ops_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    Fe x = fe_load(a + 8 * i), y = fe_load(b + 8 * i);
    uint32_t* o = out + 48 * i;
    fe_store(o, fe_add_ptx<F>(x, y));
    fe_store(o + 8, fe_add<F>(x, y));
    fe_store(o + 16, fe_sub_ptx<F>(x, y));
    fe_store(o + 24, fe_sub<F>(x, y));
    fe_store(o + 32, fe_sub_ptx<F>(fe_zero(), x));
    fe_store(o + 40, fe_neg<F>(x));
  }
}

extern "C" int field_ops_compare(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                 long long n, int field, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  if (n <= 0) return 0;
  if (field == 0)
    field_ops_kernel<Fr><<<blocks, 256, 0, st>>>(a, b, out, n);
  else if (field == 1)
    field_ops_kernel<Fq><<<blocks, 256, 0, st>>>(a, b, out, n);
  else
    return -1;
  return (int)cudaGetLastError();
}

// field: 0 = Fr, 1 = Fq; variant: 0 = integer product, 1 = float32 product,
// 2 = integer product in PTX carry chains;
// per_thread: 1, 2 or 4.  Returns 0, a CUDA error code, or -1 for an
// argument the kernel is not built for.
extern "C" int mont_mul_chain(const uint32_t* a, const uint32_t* b, uint32_t* out,
                              long long n, int chain, int field, int variant,
                              int per_thread, int blocks, int threads,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0 && variant == 0)
    return launch_chain<Fr, 0>(a, b, out, n, chain, per_thread, blocks, threads, st);
  if (field == 0 && variant == 1)
    return launch_chain<Fr, 1>(a, b, out, n, chain, per_thread, blocks, threads, st);
  if (field == 1 && variant == 0)
    return launch_chain<Fq, 0>(a, b, out, n, chain, per_thread, blocks, threads, st);
  if (field == 1 && variant == 1)
    return launch_chain<Fq, 1>(a, b, out, n, chain, per_thread, blocks, threads, st);
  if (field == 0 && variant == 2)
    return launch_chain<Fr, 2>(a, b, out, n, chain, per_thread, blocks, threads, st);
  if (field == 1 && variant == 2)
    return launch_chain<Fq, 2>(a, b, out, n, chain, per_thread, blocks, threads, st);
  return -1;
}

#endif  // __CUDACC__
