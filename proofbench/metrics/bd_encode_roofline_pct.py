"""bd_encode_roofline_pct: the least time one commit's encoding needs
(yardstick_brakedown.encode_least_work: every nonzero's and base-case
entry's product for every row, or the input, codeword and matrices' bytes
once, at the card's published peaks), summed over the profiled commits, as a
share of the device time of the encode kernel's launches in them
(csrc/brakedown.cu brakedown_dot_kernel)."""

from proofbench import brakedown_stages, yardstick_brakedown


def read(ctx):
    return brakedown_stages.roofline_pct(ctx, "brakedown_dot_kernel",
                                         yardstick_brakedown.encode_least_seconds(ctx.config["k"]))
