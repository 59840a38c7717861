"""Share (%) of a fold's time in which no operation ran on the device:
the profiled folds' busy time per fold over a fold's time without the
profiler."""
from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
