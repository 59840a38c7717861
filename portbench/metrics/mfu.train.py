"""Model FLOPs of a fold over its time without the profiler, as a share
(%) of the H100's 989 TFLOP/s (bf16): 3 × one forward's FLOPs per trained
image (forward, and the backward's two products; no recompute) and one
forward's per validated image, counted from the reference model's
shapes (``counts.forward_macs``)."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.forward_flops * (3 * ctx.trained_per_unit
                                         + ctx.validated_per_unit))
