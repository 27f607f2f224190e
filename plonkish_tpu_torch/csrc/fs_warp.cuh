// K6's round message on one warp, shared by K6's own kernel
// (fiat_shamir.cu) and K7, the fused sum-check rounds (sumcheck_fused.cuh),
// whose block 0 runs it between its grid barriers.  The pieces and the
// layouts are fiat_shamir.cuh's; this header puts them on the warp: the
// sponge across the lanes (lane i holds state lane i), keccak-f's steps by
// shuffles, the Lagrange terms summed by a shuffle reduction.
//
// The host build (g++, the CPU tests) has the same round with the lanes one
// after another between the warp's steps: fs_round_twin.
#pragma once

#include "fiat_shamir.cuh"

namespace pk {

constexpr int FS_THREADS = 32;

#ifdef __CUDACC__

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

// The sum of `a` over the warp, on every lane.
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

// One Evaluations round (fiat_shamir.cuh's layouts) on the 32 lanes of a
// warp: lane t prepares terms t and t + 32.
template <class F>
__device__ __forceinline__ void fs_round_warp(int lane, const uint32_t* sums, uint32_t* scal,
                                              uint32_t* sponge, const uint32_t* fixed,
                                              const uint32_t* rows, int degree, uint32_t* out,
                                              uint32_t* ch_mont, uint32_t* ids_next,
                                              FsShared& sh) {
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

#else  // the host build of the CPU tests

// keccak-f on the 25 lanes, each step over every lane before the next.
inline void keccak_warp_twin(uint64_t a[25]) {
  uint32_t lfsr = 1;
  for (int r = 0; r < 24; r++) {
    uint64_t c[25], t[25], b[25];
    for (int l = 0; l < 25; l++) c[l] = keccak_parity(l, [&](int j) { return a[j]; });
    for (int l = 0; l < 25; l++) t[l] = keccak_theta(l, a[l], [&](int j) { return c[j]; });
    for (int l = 0; l < 25; l++) b[l] = fs_rotl(t[keccak_pi_source(l)], keccak_rho(keccak_pi_source(l)));
    for (int l = 0; l < 25; l++) a[l] = keccak_chi(l, b[l], [&](int j) { return b[j]; });
    a[0] ^= keccak_rc(lfsr);
  }
}

template <class F>
inline Fe fs_squeeze_twin(const uint32_t* sponge, int lanes, FsShared& sh) {
  uint64_t a[25];
  for (int l = 0; l < 25; l++) a[l] = fs_sponge_lane(l, sponge);
  int base = fs_sponge_base(sponge);
  bool last = false;
  while (!last) {
    for (int l = 0; l < 25; l++) a[l] = fs_absorb_block(l, a[l], sh.words, lanes, base);
    last = fs_last_block(lanes, base);
    keccak_warp_twin(a);
    base += FS_RATE_LANES;
  }
  for (int l = 0; l < 4; l++) fs_put_lane(sh.digest, l, a[l]);
  return fs_challenge<F>(sh.digest);
}

template <class F>
inline void fs_round_twin(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                          const uint32_t* fixed, const uint32_t* rows, int degree, uint32_t* out,
                          uint32_t* ch_mont, uint32_t* ids_next) {
  FsShared sh;
  Fe m[FS_MAX_DEGREE + 1];
  for (int t = 0; t <= degree; t++) m[t] = fs_round_prepare<F>(t, sums, scal, fixed, degree, out, sh);
  Fe ch = fs_squeeze_twin<F>(sponge, 4 * (degree + 1), sh);
  Fe c = fe_to_mont<F>(ch), next = fe_zero();
  for (int t = 0; t <= degree; t++) next = fe_add<F>(next, fs_round_term<F>(t, m[t], c, degree, sh));
  for (int lane = 0; lane < FS_THREADS; lane++)
    fs_round_finish<F>(lane, FS_THREADS, next, ch, c, degree, scal, sponge, rows, out, ch_mont,
                       ids_next, sh);
}

#endif  // __CUDACC__

}  // namespace pk
