// Kernel K6, the device-resident Fiat-Shamir round message, over BN254 Fr or
// Fq: the transcript's Keccak-256 sponge and the arithmetic of one sum-check
// round message, for one warp.
//
// Port-only: no Pallas kernel corresponds.  In the JAX package the round
// message is one jitted XLA program (plonkish_tpu/piop/fiat_shamir.py:314-455:
// absorb, squeeze, reduce mod p, interpolate), which XLA fuses into a handful
// of launches; in plain torch the same Keccak-f is about 1,100 launches.  Here
// it is one launch of one warp.  Bound: latency.  The work is a few dozen
// products and two or three Keccak-f permutations; the bound by operations
// is nanoseconds, so the least time is the dependent chain
// (roofline.fs_latency_ms): the permutations' rounds and the products left
// on the critical path.
//   Design.  Lane t takes message t out of Montgomery form (one product deep
// for all t at once) and puts its canonical words in shared memory; the
// sponge then runs across the warp, lane i holding state lane i in
// registers: each block's message lanes are XORed in by the lanes of their
// rate positions (the pending byte count only shifts which message lane a
// position takes, so no array is indexed by run-time data), and keccak-f's
// steps exchange lanes by shuffles, 24 rounds in a loop (one lane's
// keccak-f was slower, with its rounds in a loop and slower still unrolled,
// whose code outgrows the instruction cache).  Then lane i computes its
// Lagrange term, all at once, and a shuffle reduction sums them.  Degrees up
// to 32 have 33 terms: lane 0 takes the 33rd.
//
// The sponge lives in device memory as SPONGE_WORDS 32-bit words and is
// updated in place: 25 state lanes, the 17 lanes of the rate buffer (each
// lane two words, low first; lane i = x + 5y, the order the rate absorbs) and
// the count of buffered bytes, a multiple of 8 below 136, as run-time data.
// A field element is absorbed as its 32-byte little-endian canonical repr
// (hash.rs:19-21), and a squeeze is finalize_reset then re-absorb of the
// digest (transcript.rs:127-131), so after a squeeze the state is zero and
// the digest's 32 bytes are pending.
//
// Every function is __host__ __device__: the CPU tests compile this header
// with g++ (csrc/cpu_twin.cpp), run the lanes one after another, and hold it
// against the plain torch version (plonkish_tpu_torch/piop/fiat_shamir.py).
#pragma once

#include "field.cuh"

namespace pk {

constexpr int FS_RATE_LANES = 17;
constexpr int FS_SPONGE_WORDS = 2 * 25 + 2 * FS_RATE_LANES + 1;
constexpr int FS_MAX_DEGREE = 32;

// R^2 mod p, to bring a canonical value into Montgomery form.
template <class F>
struct R2;

template <>
struct R2<Fr> {
  PK_HD static uint32_t v(int i) {
    const uint32_t V[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                           0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
    return V[i];
  }
};

template <>
struct R2<Fq> {
  PK_HD static uint32_t v(int i) {
    const uint32_t V[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
                           0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};
    return V[i];
  }
};

template <class F>
PK_HD Fe fe_to_mont(const Fe& a) {
  Fe r2;
#pragma unroll
  for (int i = 0; i < 8; i++) r2.v[i] = R2<F>::v(i);
  return fe_mul<F>(a, r2);
}

template <class F>
PK_HD Fe fe_from_mont(const Fe& a) {
  Fe raw1 = fe_zero();
  raw1.v[0] = 1;
  return fe_mul<F>(a, raw1);
}

PK_HD uint64_t fs_rotl(uint64_t x, int n) { return n ? (x << n) | (x >> (64 - n)) : x; }

PK_HD uint64_t fs_lane(const uint32_t* w, int i) {
  return (uint64_t)w[2 * i] | ((uint64_t)w[2 * i + 1] << 32);
}

PK_HD void fs_put_lane(uint32_t* w, int i, uint64_t v) {
  w[2 * i] = (uint32_t)v;
  w[2 * i + 1] = (uint32_t)(v >> 32);
}

// keccak-f[1600] across a warp: lane i < 25 holds the state's lane i
// (x = i % 5, y = i / 5).  A round is four steps, each a function of the
// lane and of `get(j)`, lane j's value of the step before (a shuffle on the
// card, an array read in the host twin); the rounds are a loop and their
// constants come from the LFSR of FIPS 202.  Lanes 25..31 compute nothing
// that is read.

// theta's column parity: C[x].
template <class Get>
PK_HD uint64_t keccak_parity(int lane, Get get) {
  int x = lane % 5;
  return get(x) ^ get(x + 5) ^ get(x + 10) ^ get(x + 15) ^ get(x + 20);
}

// theta: a ^ C[x - 1] ^ rot(C[x + 1], 1), the parities from lanes 0..4.
template <class Get>
PK_HD uint64_t keccak_theta(int lane, uint64_t a, Get parity) {
  int x = lane % 5;
  return a ^ parity((x + 4) % 5) ^ fs_rotl(parity((x + 1) % 5), 1);
}

// rho and pi: lane (X, Y) takes lane (x, y) = ((3Y + X) % 5, X) rotated by
// its rho offset.
PK_HD int keccak_pi_source(int lane) {
  int X = lane % 5, Y = lane / 5;
  return (3 * Y + X) % 5 + 5 * X;
}

// rho's offsets of lanes 0..24, six bits each, ten to a word.
PK_HD int keccak_rho(int lane) {
  uint64_t w = lane < 10 ? 0x5371ac91b73e040ull : lane < 20 ? 0x2153eda6766b283ull : 0xee3d092ull;
  return (int)((w >> (6 * (lane % 10))) & 63);
}

// chi: b ^ (~b[x + 1] & b[x + 2]) in the lane's row.
template <class Get>
PK_HD uint64_t keccak_chi(int lane, uint64_t b, Get get) {
  int x = lane % 5, row = lane - x;
  return b ^ (~get(row + (x + 1) % 5) & get(row + (x + 2) % 5));
}

// The next round constant from the LFSR's state (1 before round 0).
PK_HD uint64_t keccak_rc(uint32_t& lfsr) {
  uint64_t rc = 0;
#pragma unroll
  for (int j = 0; j < 7; j++) {
    if (lfsr & 1) rc ^= 1ull << ((1 << j) - 1);
    lfsr = (lfsr & 0x80) ? ((lfsr << 1) ^ 0x71) & 0xff : lfsr << 1;
  }
  return rc;
}

// What the lanes of a launch share (shared memory on the card).
struct FsShared {
  uint32_t words[8 * (FS_MAX_DEGREE + 1)];  // the message, canonical: what is absorbed
  Fe points[FS_MAX_DEGREE + 1];              // the Lagrange points, Montgomery
  uint32_t digest[8];
};

// The sponge on the warp.  Lane `lane`'s state word before the first
// block: the state's lane XOR the buffer's (its lanes beyond the count are
// zero, so the pending bytes are absorbed by this).
PK_HD uint64_t fs_sponge_lane(int lane, const uint32_t* sponge) {
  if (lane >= 25) return 0;
  uint64_t a = fs_lane(sponge, lane);
  return lane < FS_RATE_LANES ? a ^ fs_lane(sponge + 50, lane) : a;
}

// The message lane at rate position 0 of the first block: minus the count
// of pending lanes.
PK_HD int fs_sponge_base(const uint32_t* sponge) {
  return -(int)(sponge[FS_SPONGE_WORDS - 1] / 8);
}

PK_HD bool fs_last_block(int lanes, int base) { return lanes - base < FS_RATE_LANES; }

// The block whose position 0 is message lane `base` (of `lanes` in
// `words`) XORed into lane `lane`'s word, with the padding if it is the
// last block.
PK_HD uint64_t fs_absorb_block(int lane, uint64_t a, const uint32_t* words, int lanes,
                               int base) {
  int j = base + lane;
  if (lane < FS_RATE_LANES && j >= 0 && j < lanes) a ^= fs_lane(words, j);
  if (fs_last_block(lanes, base)) {
    if (lane == lanes - base) a ^= 0x01ull;
    if (lane == FS_RATE_LANES - 1) a ^= 0x8000000000000000ull;
  }
  return a;
}

// The challenge: the digest (little endian, below 2^256) mod p; p > 2^253,
// so five conditional subtractions suffice (Fp.mod_from_le_bytes).
template <class F>
PK_HD Fe fs_challenge(const uint32_t* digest) {
  Fe x = fe_load(digest);
#pragma unroll
  for (int i = 0; i < 5; i++) {
    Fe d;
    if (!sub_p<F>(d, x)) x = d;
  }
  return x;
}

// The sponge after a squeeze, lane `lane` of `count`: zero state, the
// digest pending.
PK_HD void fs_sponge_store(int lane, int count, uint32_t* sponge, const uint32_t* digest) {
  for (int w = lane; w < FS_SPONGE_WORDS; w += count)
    sponge[w] = w >= 50 && w < 58 ? digest[w - 50] : w == FS_SPONGE_WORDS - 1 ? 32u : 0u;
}

// One Evaluations round (classic/eval.rs): the message is sum - e(1), e(1),
// ..., e(d) from K3's Montgomery sums; absorbed, squeezed; the next claimed
// sum is the Lagrange form over the points 0..d at the challenge
// (w[i] * prod_{j != i} (c - j) * msg[i]; weights and points from the
// host, Montgomery); the identity offset grows by c * 2^r, and the next
// round's identity rows (K3's ids: mul, base, step) are written.
//   sums [d, 8]; scal [2, 8] (sum, offset) in and out; fixed [2(d+1), 8]
//   (weights, then points); rows [2, 3, 8]: this round's (mul, base_add,
//   step) and the next's; out [d + 2, 8]: the message, canonical, then the
//   challenge, canonical; ch_mont [8]; ids_next [3, 8].
// The lanes: each term t = 0..d fs_round_prepare; the sponge absorbs the
// message and squeezes (fs_sponge_lane .. fs_absorb_block, the warp's
// keccak-f); each term fs_round_term at the challenge; the terms summed;
// every lane fs_round_finish.

// Term t, before the squeeze: message t out of Montgomery form into out and
// sh.words, point t into sh.points; returns w_t * msg_t.
template <class F>
PK_HD Fe fs_round_prepare(int t, const uint32_t* sums, const uint32_t* scal,
                          const uint32_t* fixed, int degree, uint32_t* out, FsShared& sh) {
  Fe msg = t ? fe_load(sums + 8 * (t - 1)) : fe_sub<F>(fe_load(scal), fe_load(sums));
  Fe canon = fe_from_mont<F>(msg);
  fe_store(out + 8 * t, canon);
  fe_store(sh.words + 8 * t, canon);
  sh.points[t] = fe_load(fixed + 8 * (degree + 1 + t));
  return fe_mul<F>(msg, fe_load(fixed + 8 * t));
}

// Term t at the challenge c (Montgomery): m_t * prod_{j != t} (c - x_j), the
// factors in two chains (even and odd j) so that every lane multiplies in
// step; the skipped factor is one.
template <class F>
PK_HD Fe fs_round_term(int t, const Fe& m, const Fe& c, int degree, const FsShared& sh) {
  Fe a = m, b = fe_one<F>();
  for (int j = 0; j <= degree; j += 2) {
    a = fe_mul<F>(a, j == t ? fe_one<F>() : fe_sub<F>(c, sh.points[j]));
    if (j + 1 <= degree)
      b = fe_mul<F>(b, j + 1 == t ? fe_one<F>() : fe_sub<F>(c, sh.points[j + 1]));
  }
  return fe_mul<F>(a, b);
}

// Lane `lane` of `count` after the sum of the terms (`next`, on lane 0);
// ch the challenge, canonical, c in Montgomery form: lane 0 the next sum,
// lane 1 the offset and the next identity rows, lane 2 the challenge; every
// lane its share of the sponge's words.
template <class F>
PK_HD void fs_round_finish(int lane, int count, const Fe& next, const Fe& ch, const Fe& c,
                           int degree, uint32_t* scal, uint32_t* sponge, const uint32_t* rows,
                           uint32_t* out, uint32_t* ch_mont, uint32_t* ids_next,
                           const FsShared& sh) {
  if (lane == 0) fe_store(scal, next);
  if (lane == 1) {
    Fe off_next = fe_add<F>(fe_load(scal + 8), fe_mul<F>(c, fe_load(rows + 16)));
    fe_store(scal + 8, off_next);
    fe_store(ids_next, fe_load(rows + 24));
    fe_store(ids_next + 8, fe_add<F>(off_next, fe_load(rows + 32)));
    fe_store(ids_next + 16, fe_load(rows + 40));
  }
  if (lane == 2) {
    fe_store(out + 8 * (degree + 1), ch);
    fe_store(ch_mont, c);
  }
  fs_sponge_store(lane, count, sponge, sh.digest);
}

// One Coefficients round (classic/coeff.rs:16-39): c0 = c0_base + v0,
// c2 = v2, c1 = sum - 2 c0 - c2; absorbed, squeezed; the next sum is
// c0 + c (c1 + c c2).
//   v [2, 8] (v0, v2) Montgomery; scal [8] the sum in and out; c0_base [8];
//   out [4, 8]: c0, c1, c2 canonical, then the challenge; ch_mont [8].
// Lanes 0..2 fs_coeff_prepare, the sponge as in the Evaluations round,
// every lane fs_coeff_finish.

template <class F>
PK_HD void fs_coeff_message(const uint32_t* v, const uint32_t* scal, const uint32_t* c0_base,
                            Fe& c0, Fe& c1, Fe& c2) {
  c0 = fe_add<F>(fe_load(c0_base), fe_load(v));
  c2 = fe_load(v + 8);
  c1 = fe_sub<F>(fe_sub<F>(fe_load(scal), fe_add<F>(c0, c0)), c2);
}

// Coefficient t (< 3) of (c0, c1, c2) out of Montgomery form into out and
// sh.words.
template <class F>
PK_HD void fs_coeff_prepare(int t, const Fe& c0, const Fe& c1, const Fe& c2, uint32_t* out,
                            FsShared& sh) {
  Fe m;
#pragma unroll
  for (int w = 0; w < 8; w++) m.v[w] = t == 0 ? c0.v[w] : t == 1 ? c1.v[w] : c2.v[w];
  Fe canon = fe_from_mont<F>(m);
  fe_store(out + 8 * t, canon);
  fe_store(sh.words + 8 * t, canon);
}

// Lane `lane` of `count` after the squeeze (ch canonical, c Montgomery):
// lane 0 the next sum, lane 1 the challenge in Montgomery form, lane 2 the
// challenge; every lane its share of the sponge's words.
template <class F>
PK_HD void fs_coeff_finish(int lane, int count, const Fe& c0, const Fe& c1, const Fe& c2,
                           const Fe& ch, const Fe& c, uint32_t* scal, uint32_t* sponge,
                           uint32_t* out, uint32_t* ch_mont, const FsShared& sh) {
  if (lane == 0) fe_store(scal, fe_add<F>(c0, fe_mul<F>(c, fe_add<F>(c1, fe_mul<F>(c, c2)))));
  if (lane == 1) fe_store(ch_mont, c);
  if (lane == 2) fe_store(out + 24, ch);
  fs_sponge_store(lane, count, sponge, sh.digest);
}

}  // namespace pk
