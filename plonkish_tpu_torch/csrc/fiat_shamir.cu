// K6, the device-resident Fiat-Shamir round message (port-only; see
// fiat_shamir.cuh for what it replaces, what bounds it and its design): one
// launch of one warp a round, between K3 (whose sums it reads) and K4 (which
// reads its challenge), so that a sum-check round enqueues with no host read.
// field: 0 = Fr, 1 = Fq (kernels/__init__.py: FIELDS); any other value, or a
// degree outside 1..FS_MAX_DEGREE, is refused.
#include "fiat_shamir.cuh"

#ifdef __CUDACC__

using namespace pk;

constexpr int FS_THREADS = 32;
constexpr unsigned FS_FULL = 0xffffffffu;

__device__ __forceinline__ uint64_t fs_shfl(uint64_t v, int src) {
  uint32_t lo = __shfl_sync(FS_FULL, (uint32_t)v, src);
  uint32_t hi = __shfl_sync(FS_FULL, (uint32_t)(v >> 32), src);
  return (uint64_t)lo | ((uint64_t)hi << 32);
}

// keccak-f[1600] on the warp, lane i holding state lane i.
__device__ __forceinline__ uint64_t fs_keccak_warp(int lane, uint64_t a) {
  const int src = keccak_pi_source(lane), rot = keccak_rho(src);
  uint32_t lfsr = 1;
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    uint64_t c = keccak_parity(lane, [&](int j) { return fs_shfl(a, j); });
    a = keccak_theta(lane, a, [&](int j) { return fs_shfl(c, j); });
    a = fs_rotl(fs_shfl(a, src), rot);
    a = keccak_chi(lane, a, [&](int j) { return fs_shfl(a, j); });
    uint64_t rc = keccak_rc(lfsr);
    if (lane == 0) a ^= rc;
  }
  return a;
}

// Absorb the `lanes` message lanes of sh.words into the sponge, squeeze:
// the digest into sh.digest; returns the challenge, canonical.
template <class F>
__device__ __forceinline__ Fe fs_squeeze_warp(int lane, const uint32_t* sponge, int lanes,
                                              FsShared& sh) {
  uint64_t a = fs_sponge_lane(lane, sponge);
  int base = fs_sponge_base(sponge);
  bool last = false;
  while (!last) {
    a = fs_absorb_block(lane, a, sh.words, lanes, base);
    last = fs_last_block(lanes, base);
    a = fs_keccak_warp(lane, a);
    base += FS_RATE_LANES;
  }
  if (lane < 4) fs_put_lane(sh.digest, lane, a);
  __syncwarp();
  return fs_challenge<F>(sh.digest);
}

template <class F>
__device__ __forceinline__ Fe fs_warp_sum(Fe a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Fe b;
#pragma unroll
    for (int w = 0; w < 8; w++) b.v[w] = __shfl_xor_sync(FS_FULL, a.v[w], o);
    a = fe_add<F>(a, b);
  }
  return a;
}

template <class F>
__global__ void __launch_bounds__(FS_THREADS)
    fs_round_kernel(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                    const uint32_t* fixed, const uint32_t* rows, int degree, uint32_t* out,
                    uint32_t* ch_mont, uint32_t* ids_next) {
  __shared__ FsShared sh;
  const int lane = threadIdx.x;
  Fe m[2];
#pragma unroll
  for (int h = 0; h < 2; h++) {
    int t = lane + FS_THREADS * h;
    if (t <= degree) m[h] = fs_round_prepare<F>(t, sums, scal, fixed, degree, out, sh);
  }
  __syncwarp();
  Fe ch = fs_squeeze_warp<F>(lane, sponge, 4 * (degree + 1), sh);
  Fe c = fe_to_mont<F>(ch);
  Fe acc = fe_zero();
#pragma unroll
  for (int h = 0; h < 2; h++) {
    int t = lane + FS_THREADS * h;
    if (t <= degree) acc = fe_add<F>(acc, fs_round_term<F>(t, m[h], c, degree, sh));
  }
  acc = fs_warp_sum<F>(acc);
  fs_round_finish<F>(lane, FS_THREADS, acc, ch, c, degree, scal, sponge, rows, out, ch_mont,
                     ids_next, sh);
}

template <class F>
__global__ void __launch_bounds__(FS_THREADS)
    fs_coeff_kernel(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                    const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont) {
  __shared__ FsShared sh;
  const int lane = threadIdx.x;
  Fe c0, c1, c2;
  fs_coeff_message<F>(v, scal, c0_base, c0, c1, c2);
  if (lane < 3) fs_coeff_prepare<F>(lane, c0, c1, c2, out, sh);
  __syncwarp();
  Fe ch = fs_squeeze_warp<F>(lane, sponge, 12, sh);
  fs_coeff_finish<F>(lane, FS_THREADS, c0, c1, c2, ch, fe_to_mont<F>(ch), scal, sponge, out,
                     ch_mont, sh);
}

extern "C" int fs_round(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                        const uint32_t* fixed, const uint32_t* rows, int degree,
                        uint32_t* out, uint32_t* ch_mont, uint32_t* ids_next, int field,
                        void* stream) {
  if (degree < 1 || degree > FS_MAX_DEGREE) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fs_round_kernel<Fr><<<1, FS_THREADS, 0, st>>>(sums, scal, sponge, fixed, rows, degree, out,
                                                   ch_mont, ids_next);
  else if (field == 1)
    fs_round_kernel<Fq><<<1, FS_THREADS, 0, st>>>(sums, scal, sponge, fixed, rows, degree, out,
                                                   ch_mont, ids_next);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" int fs_coeff(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                        const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont, int field,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fs_coeff_kernel<Fr><<<1, FS_THREADS, 0, st>>>(v, scal, sponge, c0_base, out, ch_mont);
  else if (field == 1)
    fs_coeff_kernel<Fq><<<1, FS_THREADS, 0, st>>>(v, scal, sponge, c0_base, out, ch_mont);
  else
    return -1;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
