"""BatchNorm kernels' share (%) of the device's operation time in the
profiled folds, by the frozen ``counts.kernel_kind`` rule."""
from portbench.readers import kind_share


def read(ctx):
    return kind_share(ctx, "batchnorm")
