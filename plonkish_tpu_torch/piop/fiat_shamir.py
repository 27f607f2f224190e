"""Device-resident Fiat–Shamir (port of plonkish_tpu/piop/fiat_shamir.py).

The per-round transcript squeeze is the one host read of the classic
sum-check prover's loop.  Running the Keccak-256 sponge and the round
message on the device lets a round enqueue K3 -> K6 -> K4 with no host read;
every round's message and challenge come back in one transfer at the end,
and the host transcript is replayed from them (piop/sum_check.py), which must
reproduce the device's challenges bit for bit.

Bit-exact with utils/keccak.py: a squeeze is finalize_reset then re-absorb
of the digest (transcript.rs:127-131), a field element is absorbed as its
32-byte little-endian canonical repr (hash.rs:19-21).

Two forms of one sponge:

- ``DeviceSponge``, the plain version's: the 25 lanes and the 17 lanes of the
  rate buffer as two 32-bit halves in int64 tensors (flat lane i = x + 5y),
  the count of buffered bytes on the host, as in the JAX package;
- its words, ``int32[SPONGE_WORDS]``: each lane as two words, low first, then
  the buffer, then the byte count.  K6 (``csrc/fiat_shamir.cuh``) reads and
  writes this in place, the count as run-time data.

``round_message`` and ``coeff_message`` take K3's Montgomery sums (already
reduced mod p by K3's reduce launch, so the JAX package's
``digit_sums_to_canonical`` has no counterpart here) and write into buffers
the caller allocated once: on a CUDA tensor they launch K6, on a CPU tensor
they run the plain version, which repeats K6's arithmetic over the field
layer and ``utils/keccak_device.keccak_f``.
"""

from __future__ import annotations

import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from ..kernels import fiat_shamir as kfs
from ..utils.keccak_device import M32, RATE_LANES, keccak_f

SPONGE_WORDS = kfs.SPONGE_WORDS


def _i64(values, device):
    return torch.as_tensor(values, dtype=torch.int64, device=device)


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """Values below 2^32 in int64 -> the same bits in int32."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


class DeviceSponge:
    """Functional Keccak-256 sponge; the buffered-byte count is a host int
    (the sum-check only absorbs 32-byte field reprs).  Methods return new
    sponges."""

    __slots__ = ("lo", "hi", "buf_lo", "buf_hi", "nbytes")

    def __init__(self, lo, hi, buf_lo, buf_hi, nbytes: int):
        assert nbytes % 8 == 0 and 0 <= nbytes < 8 * RATE_LANES
        self.lo, self.hi = lo, hi
        self.buf_lo, self.buf_hi = buf_lo, buf_hi
        self.nbytes = nbytes

    @classmethod
    def from_host(cls, lanes, pending: bytes, device="cpu") -> "DeviceSponge":
        """A host Keccak256 state: 25 lane ints in absorb order and the
        buffered bytes (a multiple of 8: every absorb of the protocol is 32
        bytes), as ``Keccak256Transcript.export_sponge`` gives them."""
        assert len(pending) % 8 == 0 and len(pending) < 8 * RATE_LANES
        buf = [int.from_bytes(pending[8 * i: 8 * i + 8], "little")
               for i in range(len(pending) // 8)]
        buf += [0] * (RATE_LANES - len(buf))
        lanes = [int(v) for v in lanes]
        return cls(_i64([v & M32 for v in lanes], device), _i64([v >> 32 for v in lanes], device),
                   _i64([v & M32 for v in buf], device), _i64([v >> 32 for v in buf], device),
                   len(pending))

    @classmethod
    def from_words(cls, words: torch.Tensor) -> "DeviceSponge":
        """The sponge K6 keeps (``int32[SPONGE_WORDS]``); reads the byte count."""
        v = words.to(torch.int64) & M32
        return cls(v[0:50:2], v[1:50:2], v[50:84:2], v[51:84:2], int(v[84]))

    def words(self) -> torch.Tensor:
        """The same sponge as K6's words, on this sponge's device."""
        lanes = torch.stack([self.lo, self.hi], 1).reshape(-1)
        buf = torch.stack([self.buf_lo, self.buf_hi], 1).reshape(-1)
        count = _i64([self.nbytes], self.lo.device)
        return _to_int32(torch.cat([lanes, buf, count]))

    def _flush(self) -> "DeviceSponge":
        lo, hi = self.lo.clone(), self.hi.clone()
        lo[:RATE_LANES] ^= self.buf_lo
        hi[:RATE_LANES] ^= self.buf_hi
        lo, hi = keccak_f(lo[:, None], hi[:, None])
        z = torch.zeros_like(self.buf_lo)
        return DeviceSponge(lo[:, 0], hi[:, 0], z, z.clone(), 0)

    def absorb_words(self, words: torch.Tensor) -> "DeviceSponge":
        """Absorb [2k] 32-bit words (k lanes, low word first) held in int64."""
        k = words.shape[0] // 2
        lanes_lo, lanes_hi = words[0::2], words[1::2]
        s = self
        pos = 0
        while pos < k:
            off = s.nbytes // 8
            take = min(k - pos, RATE_LANES - off)
            buf_lo, buf_hi = s.buf_lo.clone(), s.buf_hi.clone()
            buf_lo[off: off + take] = lanes_lo[pos: pos + take]
            buf_hi[off: off + take] = lanes_hi[pos: pos + take]
            nbytes = s.nbytes + 8 * take
            if nbytes == 8 * RATE_LANES:
                s = DeviceSponge(s.lo, s.hi, buf_lo, buf_hi, 0)._flush()
            else:
                s = DeviceSponge(s.lo, s.hi, buf_lo, buf_hi, nbytes)
            pos += take
        return s

    def squeeze(self):
        """finalize_reset, then re-absorb the digest.  Returns (new sponge,
        digest as [8] 32-bit words in int64, little endian)."""
        buf_lo, buf_hi = self.buf_lo.clone(), self.buf_hi.clone()
        buf_lo[self.nbytes // 8] ^= 0x01  # pad10*1: 0x01 after the message
        buf_hi[RATE_LANES - 1] ^= 0x80000000  # and 0x80 at byte 135
        lo, hi = self.lo.clone(), self.hi.clone()
        lo[:RATE_LANES] ^= buf_lo
        hi[:RATE_LANES] ^= buf_hi
        lo, hi = keccak_f(lo[:, None], hi[:, None])
        digest = torch.stack([lo[:4, 0], hi[:4, 0]], 1).reshape(-1)
        z25 = torch.zeros_like(self.lo)
        z17 = torch.zeros_like(self.buf_lo)
        fresh = DeviceSponge(z25, z25.clone(), z17, z17.clone(), 0)
        return fresh.absorb_words(digest), digest


def sponge_words(transcript, device) -> torch.Tensor:
    """K6's sponge seeded from a host transcript's state (one upload)."""
    lanes, pending = transcript.export_sponge()
    return DeviceSponge.from_host(lanes, pending).words().to(device)


# ---------------------------------------------------------------------------
# Field element <-> sponge words
# ---------------------------------------------------------------------------

def digits_to_words(d: torch.Tensor) -> torch.Tensor:
    """[16, n] canonical 16-bit digits -> [8n] 32-bit words, element by
    element, each its 32-byte little-endian repr (int64)."""
    return (d[0::2] | (d[1::2] << 16)).T.reshape(-1)


def words_to_digits(words: torch.Tensor) -> torch.Tensor:
    """[8] 32-bit words -> [16, 1] 16-bit digits."""
    return torch.stack([words & 0xFFFF, words >> 16], 1).reshape(limb.D, 1)


def n_cond_subs(p: int) -> int:
    return ((1 << 256) - 1) // p


def challenge_digits(spec: FieldSpec, digest: torch.Tensor) -> torch.Tensor:
    """The digest (little endian) mod p as canonical [16, 1] digits
    (Fp.mod_from_le_bytes)."""
    c = limb._consts(spec, digest.device)
    x = words_to_digits(digest)
    for _ in range(n_cond_subs(spec.p)):
        x = limb._cond_sub(torch.cat([x, torch.zeros_like(x[:1])]), c)
    return x


def lagrange_constants(spec: FieldSpec, degree: int, device) -> torch.Tensor:
    """K6's ``fixed``: the weights w_i = 1 / prod_{j != i} (i - j) of the
    points 0..d, then the points, Montgomery int32[2(d+1), 8]."""
    weights = []
    for i in range(degree + 1):
        prod = 1
        for j in range(degree + 1):
            if j != i:
                prod = prod * (i - j) % spec.p
        weights.append(pow(prod, -1, spec.p))
    return limb.from_ints([spec.to_mont(v) for v in weights + list(range(degree + 1))], device)


# ---------------------------------------------------------------------------
# Round messages: the plain versions and the dispatch
# ---------------------------------------------------------------------------

def _absorb_message(sponge_w: torch.Tensor, canon: torch.Tensor):
    """Absorb the canonical [16, m] message, squeeze; write the sponge back.
    Returns the digest words."""
    sp = DeviceSponge.from_words(sponge_w).absorb_words(digits_to_words(canon))
    sp, digest = sp.squeeze()
    sponge_w.copy_(sp.words())
    return digest


def round_message_plain(spec, degree, sums, scal, sponge, fixed, rows, out, ch_mont,
                        ids_next) -> None:
    """K6's Evaluations round in plain torch, in place (see
    csrc/fiat_shamir.cuh fs_round_message for the layouts)."""
    c = limb._consts(spec, sums.device)
    d = degree
    ev = limb.unpack(sums)  # t = 1..d
    sc = limb.unpack(scal)  # sum, offset
    msg = torch.cat([limb.d_sub(sc[:, :1], ev[:, :1], c), ev], 1)
    canon = limb.d_mul(msg, c["raw1"], c)
    ch = challenge_digits(spec, _absorb_message(sponge, canon))
    chm = limb.d_mul(ch, c["r2"], c)
    fx = limb.unpack(fixed)
    weights, points = fx[:, : d + 1], fx[:, d + 1:]
    diffs = limb.d_sub(chm.expand(limb.D, d + 1), points, c)
    prefix, suffix = [c["one"]], [c["one"]]
    for i in range(d):
        prefix.append(limb.d_mul(prefix[-1], diffs[:, i: i + 1], c))
        suffix.append(limb.d_mul(suffix[-1], diffs[:, d - i: d - i + 1], c))
    li = limb.d_mul(torch.cat(prefix, 1), torch.cat(suffix[::-1], 1), c)
    terms = limb.d_mul(limb.d_mul(li, weights, c), msg, c)
    nxt = terms[:, :1]
    for i in range(1, d + 1):
        nxt = limb.d_add(nxt, terms[:, i: i + 1], c)
    rw = limb.unpack(rows)  # (mul, base_add, step) of this round, then the next's
    off_next = limb.d_add(sc[:, 1:2], limb.d_mul(chm, rw[:, 2:3], c), c)
    out[: d + 1] = limb.pack(canon)
    out[d + 1] = limb.pack(ch)[0]
    ch_mont.copy_(limb.pack(chm)[0])
    scal.copy_(limb.pack(torch.cat([nxt, off_next], 1)))
    ids_next.copy_(limb.pack(torch.cat(
        [rw[:, 3:4], limb.d_add(off_next, rw[:, 4:5], c), rw[:, 5:6]], 1)))


def coeff_message_plain(spec, v, scal, sponge, c0_base, out, ch_mont) -> None:
    """K6's Coefficients round in plain torch, in place (csrc/fiat_shamir.cuh
    fs_coeff_message)."""
    c = limb._consts(spec, v.device)
    vv = limb.unpack(v)
    c0 = limb.d_add(limb.unpack(c0_base), vv[:, :1], c)
    c2 = vv[:, 1:2]
    c1 = limb.d_sub(limb.d_sub(limb.unpack(scal), limb.d_add(c0, c0, c), c), c2, c)
    canon = limb.d_mul(torch.cat([c0, c1, c2], 1), c["raw1"], c)
    ch = challenge_digits(spec, _absorb_message(sponge, canon))
    chm = limb.d_mul(ch, c["r2"], c)
    out[:3] = limb.pack(canon)
    out[3] = limb.pack(ch)[0]
    ch_mont.copy_(limb.pack(chm)[0])
    nxt = limb.d_add(c0, limb.d_mul(chm, limb.d_add(c1, limb.d_mul(chm, c2, c), c), c), c)
    scal.copy_(limb.pack(nxt)[0])


def round_message(spec, degree, sums, scal, sponge, fixed, rows, out, ch_mont,
                  ids_next) -> None:
    """One Evaluations round message (K6), in place:

    - sums: K3's Montgomery sums of the round polynomial at t = 1..d, [d, 8];
    - scal: (claimed sum, identity offset), Montgomery [2, 8], advanced to
      the next round's;
    - sponge: the sponge's words, advanced past the message and the squeeze;
    - fixed: ``lagrange_constants``; rows: this round's and the next round's
      rows (mul, base_add, step) of the identity stack
      (piop/sum_check.py ``identity_stack``), [2, 3, 8];
    - out: the message at t = 0..d then the challenge, canonical [d + 2, 8];
    - ch_mont: the challenge in Montgomery form [8], K4's input;
    - ids_next: the next round's K3 identity rows (mul, base, step) [3, 8].
    """
    if sums.device.type == "cpu":
        round_message_plain(spec, degree, sums, scal, sponge, fixed, rows, out, ch_mont,
                            ids_next)
    else:
        kfs.round_cuda(spec, degree, sums, scal, sponge, fixed, rows, out, ch_mont, ids_next)


def coeff_message(spec, v, scal, sponge, c0_base, out, ch_mont) -> None:
    """One degree-2 Coefficients round message (K6), in place: v the
    Montgomery sums (v0, v2) [2, 8]; scal the claimed sum [8], advanced;
    c0_base this round's size * constant [8]; out (c0, c1, c2, challenge)
    canonical [4, 8]; ch_mont [8]."""
    if v.device.type == "cpu":
        coeff_message_plain(spec, v, scal, sponge, c0_base, out, ch_mont)
    else:
        kfs.coeff_cuda(spec, v, scal, sponge, c0_base, out, ch_mont)
