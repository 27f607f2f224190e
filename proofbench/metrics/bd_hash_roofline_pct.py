"""bd_hash_roofline_pct: the least time one commit's column hashes and Merkle
tree need (yardstick_brakedown.hash_least_work: 4,320 32-bit operations a
Keccak-f[1600] at the yardstick's integer rate, or the codeword's bytes
once), summed over the profiled commits, as a share of the device time of
the hash kernel's launches in them (csrc/merkle.cu keccak_messages_kernel)."""

from proofbench import brakedown_stages, yardstick_brakedown


def read(ctx):
    return brakedown_stages.roofline_pct(ctx, "keccak_messages_kernel",
                                         yardstick_brakedown.hash_least_seconds(ctx.config["k"]))
