"""The image path's kernels over the traced stretch: the least time of the
tower's and projector's products and of the image rows' prefill chunks
(kernel F at 256 rows) over the device time inside the image jobs'
spans, in %."""

from portbench.readings import busy_within, least_time_s, traced


def read(ctx):
    if not traced(ctx, "embeds"):
        return None
    busy = busy_within(ctx, "image.job")
    if busy <= 0:
        return None
    return 100.0 * least_time_s(ctx, ("image", "embeds")) / busy
