// Copied from plonkish_tpu/ops/keccak_native.cpp; built with g++ into
// plonkish_tpu_torch/_build/ by plonkish_tpu_torch/ops/_keccak_native.py.
// Batch Keccak-256 (Ethereum-style padding 0x01) for commitment hashing.
//
// The Brakedown commit path hashes thousands of codeword columns plus two
// merkle levels per depth (reference brakedown.rs:152-190 uses Rust sha3);
// this native kernel provides the same throughput class for the Python
// runtime via a flat (buffer, offsets) batch API exposed through ctypes.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int kRounds = 24;

constexpr uint64_t kRC[kRounds] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

constexpr int kRotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                           27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
constexpr int kPiln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                           15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};

inline uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

void keccak_f(uint64_t st[25]) {
  for (int round = 0; round < kRounds; ++round) {
    uint64_t bc[5];
    for (int i = 0; i < 5; ++i) {
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    }
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    uint64_t t = st[1];
    for (int i = 0; i < 24; ++i) {
      int j = kPiln[i];
      uint64_t tmp = st[j];
      st[j] = rotl64(t, kRotc[i]);
      t = tmp;
    }
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
      for (int i = 0; i < 5; ++i) {
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
      }
    }
    st[0] ^= kRC[round];
  }
}

constexpr size_t kRate = 136;

void keccak256_one(const uint8_t* data, size_t len, uint8_t* out) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  while (len >= kRate) {
    for (size_t i = 0; i < kRate / 8; ++i) {
      uint64_t lane;
      std::memcpy(&lane, data + 8 * i, 8);
      st[i] ^= lane;
    }
    keccak_f(st);
    data += kRate;
    len -= kRate;
  }
  uint8_t block[kRate];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, data, len);
  block[len] ^= 0x01;
  block[kRate - 1] ^= 0x80;
  for (size_t i = 0; i < kRate / 8; ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    st[i] ^= lane;
  }
  keccak_f(st);
  std::memcpy(out, st, 32);
}

}  // namespace

extern "C" {

// Hash n blobs packed in `buf`; blob i spans [offsets[i], offsets[i+1]).
// `out` receives n*32 bytes.
void keccak256_batch(const uint8_t* buf, const uint64_t* offsets, uint64_t n,
                     uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    keccak256_one(buf + offsets[i], offsets[i + 1] - offsets[i],
                  out + 32 * i);
  }
}

void keccak256_single(const uint8_t* buf, uint64_t len, uint8_t* out) {
  keccak256_one(buf, len, out);
}

}  // extern "C"
