"""bd_hash_ms: milliseconds a commit's Keccak-256 hashing (the column hashes
and every level of the Merkle tree, csrc/merkle.cu via pcs/brakedown.py)
stretches over on the card, the card's idle time inside included: the device
stretches of the stages brakedown_columns-k and brakedown_merkle-k under each
brakedown_commit-k root of plonkish_tpu_torch's timer, summed, over the
commits the profiler did not record."""

from proofbench import brakedown_stages


def read(ctx):
    return brakedown_stages.stage_ms(ctx, ["brakedown_columns", "brakedown_merkle"])
