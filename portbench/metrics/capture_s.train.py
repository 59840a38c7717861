"""Seconds the fused runner spent warming up and capturing its CUDA
graphs (``FusedRunner.stats["capture_s"]``): the set-up fold's, since the
window's folds replay that runner's graphs."""


def read(ctx):
    v = ctx.counters.get("capture_s")
    return float(v) if v else None
