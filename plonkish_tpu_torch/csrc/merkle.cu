// Keccak-256 of many equal-length messages, one a thread: Brakedown's column
// hashes and every level of its Merkle tree (pcs/brakedown.py), the
// upstream's merklize (brakedown.rs:152-190).
//
// Port-only: no Pallas kernel corresponds.  The JAX package hashes in XLA
// and the port's plain version (utils/keccak_device.py) in int64 torch
// operations over [25, N] lane halves, some 1,100 launches a Keccak-f; here
// one launch hashes all the messages of a level.  Message i is `lanes`
// 64-bit little-endian words at words + i * lanes: a column of the canonical
// codeword ([codeword_len, rows, 8] int32: the rows' 32-byte values, row
// after row, 1 KiB at 32 rows) or two neighbouring nodes of the level below
// (8 lanes).  Threads from n to `width` write zero digests: the leaves that
// pad the tree to a power of two.
//
// Keccak-f[1600] is K6's (fiat_shamir.cuh: the theta, rho and pi, chi and
// round-constant steps), here with the 25 lanes in one thread's registers:
// every lane index is a constant once the lane loops are unrolled, so the
// state never leaves them; the rounds stay a loop, their constants from the
// LFSR.  Original Keccak padding (0x01 ... 0x80), as the upstream's
// sha3::Keccak256.
//
// Bound: operations.  At k = 20 a commit is 56,361 columns of 8 Keccak-f and
// 65,535 nodes of one, about 516 k permutations of some 4,300 32-bit
// operations each; the bytes (the codeword once) are a tenth of that time.
#include "fiat_shamir.cuh"

namespace pk {

constexpr int KECCAK_RATE_LANES = 17;

// keccak-f[1600] on the 25 lanes of one thread.
PK_HD void keccak_f_lanes(uint64_t a[25]) {
  uint32_t lfsr = 1;
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = keccak_parity(x, [&](int j) { return a[j]; });
#pragma unroll
    for (int l = 0; l < 25; l++) a[l] = keccak_theta(l, a[l], [&](int j) { return c[j]; });
#pragma unroll
    for (int l = 0; l < 25; l++)
      b[l] = fs_rotl(a[keccak_pi_source(l)], keccak_rho(keccak_pi_source(l)));
#pragma unroll
    for (int l = 0; l < 25; l++) a[l] = keccak_chi(l, b[l], [&](int j) { return b[j]; });
    a[0] ^= keccak_rc(lfsr);
  }
}

// Message i of `n`: its Keccak-256 digest as four lanes at out + 4 * i (zero
// for n <= i < width).
PK_HD void keccak_message_item(int64_t i, const uint64_t* words, int lanes, int64_t n,
                               uint64_t* out) {
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; l++) a[l] = 0;
  if (i < n) {
    const uint64_t* msg = words + i * lanes;
    for (int base = 0;; base += KECCAK_RATE_LANES) {
      bool last = lanes - base < KECCAK_RATE_LANES;
#pragma unroll
      for (int l = 0; l < KECCAK_RATE_LANES; l++) {
        int w = base + l;
        uint64_t v = w < lanes ? msg[w] : 0;
        if (last && w == lanes) v ^= 0x01ull;
        if (last && l == KECCAK_RATE_LANES - 1) v ^= 0x8000000000000000ull;
        a[l] ^= v;
      }
      keccak_f_lanes(a);
      if (last) break;
    }
  }
#pragma unroll
  for (int l = 0; l < 4; l++) out[4 * i + l] = a[l];
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

__global__ void keccak_messages_kernel(const uint64_t* words, int lanes, int64_t n,
                                       int64_t width, uint64_t* out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  keccak_message_item(i, words, lanes, n, out);
}

// words: n messages of `lanes` 64-bit words, contiguous, 8-byte aligned; out:
// `width` >= n digests of four words.  Enqueues one launch on `stream` and
// returns 0, a CUDA error code, or -1 for a shape it does not take.
extern "C" int keccak_messages(const uint64_t* words, int lanes, long long n, long long width,
                               uint64_t* out, int threads, void* stream) {
  if (lanes < 0 || n < 0 || width < n || threads <= 0) return -1;
  if (width == 0) return 0;
  long long grid = (width + threads - 1) / threads;
  keccak_messages_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(words, lanes, n,
                                                                               width, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
