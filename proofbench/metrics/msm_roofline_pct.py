"""msm_roofline_pct: the least time one MSM of the commitment's size needs
(yardstick.msm_least_work: GLV halves, signed-digit buckets, batch-affine
additions, at the card's published peaks), summed over the profiled
commitments, as a share of the device time of every operation that those
commitments ran on the card (recode, sort, K1, K2, the conversion out of
Montgomery form and the copies)."""

from proofbench import yardstick


def read(ctx):
    if ctx.device is None:
        return None
    traced = ctx.answered[:ctx.traced]  # not the draws of the inputs
    device_s = ctx.device.kernel_seconds_within(traced)
    if device_s <= 0:
        return None
    least = ctx.traced * yardstick.least_seconds(yardstick.msm_least_work(1 << ctx.config["k"]))
    return 100.0 * least / device_s
