// Kernel K6, the device-resident Fiat-Shamir round message, over BN254 Fr or
// Fq: the transcript's Keccak-256 sponge and the arithmetic of one sum-check
// round message, for one thread.
//
// Port-only: no Pallas kernel corresponds.  In the JAX package the round
// message is one jitted XLA program (plonkish_tpu/piop/fiat_shamir.py:314-455:
// absorb, squeeze, reduce mod p, interpolate), which XLA fuses into a handful
// of launches; in plain torch the same Keccak-f is about 1,100 launches.  Here
// it is one launch of one thread.  Bound: latency.  The work is a few dozen
// products and two or three Keccak-f permutations, a few microseconds of one
// thread's dependent instructions; the bound by operations is nanoseconds.
//
// The sponge lives in device memory as SPONGE_WORDS 32-bit words and is
// updated in place: 25 state lanes, the 17 lanes of the rate buffer (each
// lane two words, low first; lane i = x + 5y, the order the rate absorbs) and
// the count of buffered bytes, a multiple of 8 below 136, as run-time data.
// A field element is absorbed as its 32-byte little-endian canonical repr
// (hash.rs:19-21), and a squeeze is finalize_reset then re-absorb of the
// digest (transcript.rs:127-131), so after a squeeze 32 bytes are pending.
//
// Every function is __host__ __device__: the CPU tests compile this header
// with g++ (csrc/cpu_twin.cpp) and hold it against the plain torch version
// (plonkish_tpu_torch/piop/fiat_shamir.py).
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

PK_HD uint64_t fs_rotl(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

// keccak-f[1600] on lanes st[x + 5y].
PK_HD void keccak_f1600(uint64_t st[25]) {
  const uint64_t RC[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  // rho and pi, walked along the lane cycle that starts at lane 1
  const int ROT[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                       27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int PI[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                      15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  uint64_t bc[5];
  for (int r = 0; r < 24; r++) {
#pragma unroll
    for (int x = 0; x < 5; x++) bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      uint64_t t = bc[(x + 4) % 5] ^ fs_rotl(bc[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) st[y + x] ^= t;
    }
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; i++) {
      uint64_t next = st[PI[i]];
      st[PI[i]] = fs_rotl(t, ROT[i]);
      t = next;
    }
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; x++) bc[x] = st[y + x];
#pragma unroll
      for (int x = 0; x < 5; x++) st[y + x] ^= (~bc[(x + 1) % 5]) & bc[(x + 2) % 5];
    }
    st[0] ^= RC[r];
  }
}

struct Sponge {
  uint64_t st[25];
  uint64_t buf[FS_RATE_LANES];
  uint32_t nbytes;
};

PK_HD uint64_t fs_lane(const uint32_t* w, int i) {
  return (uint64_t)w[2 * i] | ((uint64_t)w[2 * i + 1] << 32);
}

PK_HD void fs_put_lane(uint32_t* w, int i, uint64_t v) {
  w[2 * i] = (uint32_t)v;
  w[2 * i + 1] = (uint32_t)(v >> 32);
}

PK_HD Sponge sponge_load(const uint32_t* w) {
  Sponge s;
  for (int i = 0; i < 25; i++) s.st[i] = fs_lane(w, i);
  for (int i = 0; i < FS_RATE_LANES; i++) s.buf[i] = fs_lane(w + 50, i);
  s.nbytes = w[50 + 2 * FS_RATE_LANES];
  return s;
}

PK_HD void sponge_store(uint32_t* w, const Sponge& s) {
  for (int i = 0; i < 25; i++) fs_put_lane(w, i, s.st[i]);
  for (int i = 0; i < FS_RATE_LANES; i++) fs_put_lane(w + 50, i, s.buf[i]);
  w[50 + 2 * FS_RATE_LANES] = s.nbytes;
}

PK_HD void sponge_absorb_lane(Sponge& s, uint64_t lane) {
  s.buf[s.nbytes / 8] = lane;
  s.nbytes += 8;
  if (s.nbytes == 8 * FS_RATE_LANES) {
    for (int i = 0; i < FS_RATE_LANES; i++) {
      s.st[i] ^= s.buf[i];
      s.buf[i] = 0;
    }
    keccak_f1600(s.st);
    s.nbytes = 0;
  }
}

// Absorb one canonical element as its 32-byte little-endian repr.
PK_HD void sponge_absorb_fe(Sponge& s, const Fe& canon) {
  for (int j = 0; j < 4; j++) sponge_absorb_lane(s, fs_lane(canon.v, j));
}

// finalize_reset, then re-absorb the digest; returns the digest as 8 words.
PK_HD Fe sponge_squeeze(Sponge& s) {
  s.buf[s.nbytes / 8] ^= 0x01ull;
  s.buf[FS_RATE_LANES - 1] ^= 0x8000000000000000ull;
  for (int i = 0; i < FS_RATE_LANES; i++) s.st[i] ^= s.buf[i];
  keccak_f1600(s.st);
  Fe digest;
  for (int j = 0; j < 4; j++) fs_put_lane(digest.v, j, s.st[j]);
  for (int i = 0; i < 25; i++) s.st[i] = 0;
  for (int i = 0; i < FS_RATE_LANES; i++) s.buf[i] = 0;
  s.nbytes = 0;
  for (int j = 0; j < 4; j++) sponge_absorb_lane(s, fs_lane(digest.v, j));
  return digest;
}

// The digest (little endian, below 2^256) mod p: p > 2^253, so five
// conditional subtractions suffice (Fp.mod_from_le_bytes).
template <class F>
PK_HD Fe fs_challenge(const Fe& digest) {
  Fe x = digest;
  for (int i = 0; i < 5; i++) {
    Fe d;
    if (!sub_p<F>(d, x)) x = d;
  }
  return x;
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
template <class F>
PK_HD void fs_round_message(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                            const uint32_t* fixed, const uint32_t* rows, int degree,
                            uint32_t* out, uint32_t* ch_mont, uint32_t* ids_next) {
  Fe msg[FS_MAX_DEGREE + 1];
  Fe sum = fe_load(scal), off = fe_load(scal + 8);
  for (int t = 1; t <= degree; t++) msg[t] = fe_load(sums + 8 * (t - 1));
  msg[0] = fe_sub<F>(sum, msg[1]);
  Sponge s = sponge_load(sponge);
  for (int t = 0; t <= degree; t++) {
    Fe canon = fe_from_mont<F>(msg[t]);
    fe_store(out + 8 * t, canon);
    sponge_absorb_fe(s, canon);
  }
  Fe ch = fs_challenge<F>(sponge_squeeze(s));
  sponge_store(sponge, s);
  fe_store(out + 8 * (degree + 1), ch);
  Fe c = fe_to_mont<F>(ch);
  fe_store(ch_mont, c);

  // Lagrange form: prefix products of (c - j) left of i, suffix right of i
  Fe suffix[FS_MAX_DEGREE + 2];
  suffix[degree + 1] = fe_one<F>();
  for (int i = degree; i >= 0; i--)
    suffix[i] = fe_mul<F>(suffix[i + 1], fe_sub<F>(c, fe_load(fixed + 8 * (degree + 1 + i))));
  Fe prefix = fe_one<F>(), next = fe_zero();
  for (int i = 0; i <= degree; i++) {
    Fe li = fe_mul<F>(prefix, suffix[i + 1]);
    next = fe_add<F>(next, fe_mul<F>(fe_mul<F>(li, fe_load(fixed + 8 * i)), msg[i]));
    prefix = fe_mul<F>(prefix, fe_sub<F>(c, fe_load(fixed + 8 * (degree + 1 + i))));
  }
  Fe off_next = fe_add<F>(off, fe_mul<F>(c, fe_load(rows + 16)));
  fe_store(scal, next);
  fe_store(scal + 8, off_next);
  fe_store(ids_next, fe_load(rows + 24));
  fe_store(ids_next + 8, fe_add<F>(off_next, fe_load(rows + 32)));
  fe_store(ids_next + 16, fe_load(rows + 40));
}

// One Coefficients round (classic/coeff.rs:16-39): c0 = c0_base + v0,
// c2 = v2, c1 = sum - 2 c0 - c2; absorbed, squeezed; the next sum is
// c0 + c (c1 + c c2).
//   v [2, 8] (v0, v2) Montgomery; scal [8] the sum in and out; c0_base [8];
//   out [4, 8]: c0, c1, c2 canonical, then the challenge; ch_mont [8].
template <class F>
PK_HD void fs_coeff_message(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                            const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont) {
  Fe c0 = fe_add<F>(fe_load(c0_base), fe_load(v));
  Fe c2 = fe_load(v + 8);
  Fe c1 = fe_sub<F>(fe_sub<F>(fe_load(scal), fe_add<F>(c0, c0)), c2);
  Fe msg[3] = {c0, c1, c2};
  Sponge s = sponge_load(sponge);
  for (int t = 0; t < 3; t++) {
    Fe canon = fe_from_mont<F>(msg[t]);
    fe_store(out + 8 * t, canon);
    sponge_absorb_fe(s, canon);
  }
  Fe ch = fs_challenge<F>(sponge_squeeze(s));
  sponge_store(sponge, s);
  fe_store(out + 24, ch);
  Fe c = fe_to_mont<F>(ch);
  fe_store(ch_mont, c);
  fe_store(scal, fe_add<F>(c0, fe_mul<F>(c, fe_add<F>(c1, fe_mul<F>(c, c2)))));
}

}  // namespace pk
