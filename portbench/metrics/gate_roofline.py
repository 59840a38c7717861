"""The attention gate kernel's share (%) of its roofline in the profiled
window: the least time of every gate call (frozen byte and operation
counts, ``counts.gate_bytes_ops``; 3.35 TB/s, 989 TFLOP/s bf16) over the
device time of the gate kernels (``counts.GATE_KERNELS``).

Where the profile recorded the ``segtpu_torch::attention_gate`` calls
(eager forwards) each call is counted at its own
shapes. Where it did not (the calls sit in replayed CUDA graphs, as the
validation forwards of a training fold do) the calls are those of one
forward of ``batch_size`` images at the configuration's levels (its
decoder's up-channels, the encoder's skip channels, the gates'
intermediate width, the skip's size), one kernel launch each: the
launches profiled, taken level after level."""
from portbench import counts
from portbench.readers import roofline

ops = ("segtpu_torch::attention_gate",)


def _bytes_ops(shapes, dtype):
    g, x, ag = shapes[0], shapes[1], shapes[2]
    m = g[0] * g[1] * g[2]
    return counts.gate_bytes_ops(m, g[3], x[3], ag[1], dtype)


def _config_calls(ctx):
    """(shapes, dtypes) of one forward's gate calls, from the
    configuration: level 4 first, as the decoder runs them."""
    cfg, p = ctx.model_cfg, ctx.traffic
    b, s = int(p["batch_size"]), int(p["image_size"])
    calls = []
    for i, lvl in enumerate((4, 3, 2, 1)):
        hw = s >> lvl
        cg, cx = cfg["decoder_up"][i], cfg["encoder_channels"][lvl - 1]
        f = cfg["attention_intermediate"][i]
        calls.append([[b, hw, hw, cg], [b, hw, hw, cx], [cg, f]])
    return calls


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.model_cfg.get("use_attention"):
        return None
    if not any(name == ops[0] for name, _, _ in tr.ops):
        launches = sum(1 for n, _, _ in tr.device_ops
                       if any(k in n for k in counts.GATE_KERNELS))
        calls = _config_calls(ctx)
        tr.ops.extend((ops[0], calls[j % len(calls)], ["c10::BFloat16"])
                      for j in range(launches))
    return roofline(ctx, ops[0], counts.GATE_KERNELS, _bytes_ops)
