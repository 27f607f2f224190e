"""The port's copied host layer against the reference: a scripted transcript
gives the same bytes and challenges (identity point as 64 zero bytes
included), and the random circuits consume the Python RNG identically."""

import random

import pytest

from plonkish_tpu.curves.host import AffinePoint as RefAffine
from plonkish_tpu.curves.specs import BN254_G1 as REF_G1
from plonkish_tpu.fields import BN254_FR as REF_FR, Fp as RefFp
from plonkish_tpu.models import circuits as ref_circuits
from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript
from plonkish_tpu_torch.curves.host import AffinePoint
from plonkish_tpu_torch.curves.specs import BN254_G1
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript


def _script(tr, fp, point, identity, g):
    tr.common_field_element(fp(5))
    tr.write_field_element(fp(BN254_FR.p - 1))
    c1 = tr.squeeze_challenge()
    tr.write_point(g.scalar_mul(7))
    tr.write_point(identity)
    c2 = tr.squeeze_challenges(3)
    tr.write_field_elements([fp(i * i) for i in range(4)])
    return [int(c1)] + [int(c) for c in c2] + [int(tr.squeeze_challenge())]


def test_transcript_bytes_and_challenges():
    ours = Keccak256Transcript(BN254_FR)
    theirs = RefTranscript(REF_FR)
    ch_ours = _script(ours, lambda v: Fp(v, BN254_FR), None,
                      AffinePoint.identity(BN254_G1), AffinePoint.generator(BN254_G1))
    ch_ref = _script(theirs, lambda v: RefFp(v, REF_FR), None,
                     RefAffine.identity(REF_G1), RefAffine.generator(REF_G1))
    proof = ours.into_proof()
    assert proof == theirs.into_proof()
    assert ch_ours == ch_ref
    assert proof[32 + 64: 32 + 128] == b"\x00" * 64  # identity on the wire
    reader = Keccak256Transcript.from_proof(BN254_FR, proof)
    assert int(reader.read_field_element()) == BN254_FR.p - 1
    reader.squeeze_challenge()
    assert reader.read_point(BN254_G1) == AffinePoint.generator(BN254_G1).scalar_mul(7)
    assert reader.read_point(BN254_G1).is_identity()


def _info(ci):
    return (
        ci.k, ci.num_instances, [[int(v) for v in col] for col in ci.preprocess_polys],
        ci.num_witness_polys, ci.num_challenges, [repr(c) for c in ci.constraints],
        [[(repr(a), repr(b)) for a, b in lk] for lk in ci.lookups], ci.permutations,
        ci.max_degree,
    )


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("name", ["rand_vanilla_plonk_circuit",
                                  "rand_vanilla_plonk_with_lookup_circuit"])
def test_circuit_info_equal(k, name):
    ci, circuit = getattr(circuits, name)(BN254_FR, k, random.Random(1), random.Random(2))
    rci, rcircuit = getattr(ref_circuits, name)(REF_FR, k, random.Random(1), random.Random(2))
    assert _info(ci) == _info(rci)
    assert [[int(v) for v in c] for c in circuit.instances()] == \
        [[int(v) for v in c] for c in rcircuit.instances()]
    assert [[int(v) for v in c] for c in circuit.synthesize(0, [])] == \
        [[int(v) for v in c] for c in rcircuit.synthesize(0, [])]
