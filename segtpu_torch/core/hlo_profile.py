"""Collective and kernel attribution of a profiled run, and the scaling
models (port of ``segtpu/core/hlo_profile.py``).

The JAX package parses the optimized HLO text of a compiled program to
find its collectives and charge its bytes. A PyTorch program has no HLO:
its counterpart reads a ``torch.profiler`` run (``record_shapes=True``)
under the same public names. ``extract_collectives`` and
``collective_summary`` count the c10d collectives from the backend's
recorded ops (``gloo:all_reduce``, ``nccl:all_reduce``, ``gloo:send``,
…) and their input shapes and dtypes; ``profile_trace`` sums the
device time by kind: cuDNN's forward, data-gradient and weight-gradient
convolutions, BatchNorm, the port's kernels, collectives, the rest.

The scaling models are the JAX package's formulas. Their link bandwidth
defaults to the H100 SXM's NVLink datasheet figure, not a measurement;
pass the measured or intended one.
"""

from __future__ import annotations

from collections import defaultdict

# NVIDIA's H100 SXM datasheet: NVLink 4, 900 GB/s per GPU, both
# directions together, so 450 GB/s each way. A datasheet value, not a
# measurement of this port.
H100_NVLINK_GBPS = 450e9

_DTYPE_BYTES = {
    "double": 8, "float": 4, "c10::BFloat16": 2, "c10::Half": 2,
    "long int": 8, "long": 8, "int": 4, "short": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}

#: the backends' recorded op → the JAX package's opcode names
_OPCODES = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather": "all-gather", "allgather": "all-gather",
    "_allgather_base": "all-gather", "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all": "all-to-all",
    "alltoall_base": "all-to-all", "broadcast": "broadcast",
    "send": "send", "recv": "recv", "reduce": "reduce",
    "gather": "gather", "scatter": "scatter",
}

#: the port's kernels by the names the profiler shows: every
#: ``__global__`` function of ``segtpu_torch/csrc/*.cu``, the gate's two
#: first
PORT_KERNELS = ("gate_bf16_kernel", "attention_gate_kernel",
                "upsample_bf16_kernel", "upsample2x_concat_kernel",
                "conv_wgmma_kernel", "conv_bf16_kernel", "conv_f32_kernel",
                "pair_wgmma_kernel", "pair_bf16_kernel", "pair_f32_kernel")


def _event_bytes(e) -> int:
    """The bytes of an event's recorded tensor inputs."""
    dtypes = getattr(e, "input_dtypes", None) or []
    total = 0
    for i, shape in enumerate(e.input_shapes or []):
        if not shape or not all(isinstance(d, int) for d in shape):
            continue
        n = 1
        for d in shape:
            n *= d
        dt = dtypes[i] if i < len(dtypes) else "float"
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def extract_collectives(prof, world: int = None) -> list:
    """Every collective and point-to-point op of a profiled run, in order.

    ``prof``: a finished ``torch.profiler.profile`` (``record_shapes=
    True``). Returns dicts: opcode (the JAX package's names:
    ``all-reduce``, ``all-gather``, …, plus ``send``/``recv``/
    ``broadcast``), backend, payload_bytes (the input's bytes; for an
    all-gather the gathered output's, input × ``world``, default the
    initialised group's size), in_bytes, shape, dtype, name (the recorded
    op)."""
    if world is None:
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
    out = []
    for e in prof.events():
        backend, _, op = e.name.partition(":")
        if backend not in ("gloo", "nccl", "mpi", "ucc") \
                or op not in _OPCODES:
            continue
        opcode = _OPCODES[op]
        b = _event_bytes(e)
        out.append({
            "opcode": opcode, "backend": backend,
            "payload_bytes": b * world if opcode == "all-gather" else b,
            "in_bytes": b,
            "shape": [list(s) for s in (e.input_shapes or [])],
            "dtype": list(getattr(e, "input_dtypes", None) or []),
            "name": e.name,
        })
    return out


def collective_summary(prof, world: int = None) -> dict:
    """Aggregate: {per_op: {opcode: {count, payload_bytes}}, total
    payload bytes, count}."""
    per = defaultdict(lambda: [0, 0])
    for c in extract_collectives(prof, world):
        per[c["opcode"]][0] += 1
        per[c["opcode"]][1] += c["payload_bytes"]
    return {
        "per_op": {k: {"count": v[0], "payload_bytes": v[1]}
                   for k, v in sorted(per.items(), key=lambda kv: -kv[1][1])},
        "total_payload_bytes": sum(v[1] for v in per.values()),
        "count": sum(v[0] for v in per.values()),
    }


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its name."""
    n = name.lower()
    if "nccl" in n:
        return "collective"
    if any(k in name for k in PORT_KERNELS):
        return "port_kernel"
    if "dgrad" in n:
        return "conv_dgrad"
    if "wgrad" in n:
        return "conv_wgrad"
    if "batch_norm" in n or "batchnorm" in n or "bn_fw" in n \
            or "bn_bw" in n:
        return "batchnorm"
    if ("conv" in n or "implicit" in n or "fprop" in n
            or "xmma" in n or "cudnn" in n):
        return "conv_fwd"
    if "gemm" in n or "sm90_" in n or "cutlass" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def profile_trace(prof) -> dict:
    """Device time of a profiled run by kind (ms: ``conv_fwd``,
    ``conv_dgrad``, ``conv_wgrad``, ``batchnorm``, ``port_kernel``,
    ``collective``, ``gemm``, ``copy``, ``other``), the device total, the
    host time inside the gloo collectives (which the device does not see)
    and the five kernels with the most device time."""
    from torch.autograd import DeviceType

    by_kind = defaultdict(float)
    by_name = defaultdict(float)
    host_coll = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_kind[kernel_kind(e.name)] += ms
            by_name[e.name] += ms
        elif e.name.partition(":")[0] == "gloo" and \
                e.name.partition(":")[2] in _OPCODES:
            host_coll += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_ms": dict(sorted(by_kind.items(),
                                     key=lambda kv: -kv[1])),
            "device_total_ms": sum(by_kind.values()),
            "gloo_host_ms": host_coll,
            "top": [[n[:80], t] for n, t in top]}


# ----------------------------------------------------------- scaling models

def ring_allreduce_time(payload_bytes: float, n: int,
                        bw_bidir: float = 2 * H100_NVLINK_GBPS) -> float:
    """Bandwidth-bound ring all-reduce: reduce-scatter + all-gather each
    move V·(N−1)/N over the ring → T = 2·V·(N−1)/(N·W_bidir)."""
    if n <= 1:
        return 0.0
    return 2.0 * payload_bytes * (n - 1) / (n * bw_bidir)


def predict_dp_scaling(allreduce_bytes: float, step_time_s: float,
                       n_list=(2, 4, 8), overlap: float = 0.0,
                       link_gbps: float = H100_NVLINK_GBPS) -> list:
    """Weak-scaling DP efficiency table: the per-rank batch (and so the
    compute time ``step_time_s``) held fixed while ranks are added; each
    step pays one gradient all-reduce of ``allreduce_bytes``, of which
    ``overlap`` ∈ [0, 1] hides under the backward pass. The "1d" columns
    ring over 2·``link_gbps``, the "2d" ones over 4·``link_gbps`` (the
    JAX package's two bounds, there with the TPU's per-link rate).

    Returns [{n, t_allreduce_1d_ms, t_allreduce_2d_ms, efficiency_1d,
    efficiency_2d, throughput_scale_1d, throughput_scale_2d}, ...].
    """
    rows = []
    for n in n_list:
        t1 = ring_allreduce_time(allreduce_bytes, n,
                                 2 * link_gbps) * (1 - overlap)
        t2 = ring_allreduce_time(allreduce_bytes, n,
                                 4 * link_gbps) * (1 - overlap)
        e1 = step_time_s / (step_time_s + t1)
        e2 = step_time_s / (step_time_s + t2)
        rows.append({
            "n": n,
            "t_allreduce_1d_ms": t1 * 1e3,
            "t_allreduce_2d_ms": t2 * 1e3,
            "efficiency_1d": e1,
            "efficiency_2d": e2,
            "throughput_scale_1d": n * e1,
            "throughput_scale_2d": n * e2,
        })
    return rows


def predict_2d_mesh_scaling(grad_phase_bytes: float, halo_bytes: float,
                            halo_nd: int, step_time_s: float,
                            shapes=((8, 1), (4, 2), (2, 4), (1, 8)),
                            link_gbps: float = H100_NVLINK_GBPS,
                            ag_bytes: float = 0.0) -> list:
    """Strong-scaling table for a 2-D (data × spatial) training mesh: a
    gradient all-reduce of ``grad_phase_bytes`` per mesh axis (rings over
    each axis's links), the halo exchange of ``halo_bytes`` per rank
    measured at data-axis size ``halo_nd`` (∝ the local batch, zero
    without a spatial axis), spatial all-gathers of ``ag_bytes`` (also
    measured at ``halo_nd``), and compute divided over all nd·ns ranks.

    Returns [{nd, ns, t_comp_ms, t_allreduce_ms, t_halo_ms,
    t_allgather_ms, efficiency, speedup}, ...].
    """
    bw = 2 * link_gbps
    rows = []
    for nd, ns in shapes:
        n = nd * ns
        if nd > 1 and ns > 1:
            t_ar = (ring_allreduce_time(grad_phase_bytes, nd, bw)
                    + ring_allreduce_time(grad_phase_bytes, ns, bw))
        else:
            t_ar = ring_allreduce_time(grad_phase_bytes, n, bw)
        t_halo = (halo_bytes * halo_nd / nd / link_gbps) if ns > 1 else 0.0
        t_ag = (ag_bytes * halo_nd / nd * (ns - 1) / ns / bw
                if ns > 1 else 0.0)
        t_comp = step_time_s / n
        t_total = t_comp + t_ar + t_halo + t_ag
        rows.append({
            "nd": nd, "ns": ns,
            "t_comp_ms": t_comp * 1e3,
            "t_allreduce_ms": t_ar * 1e3,
            "t_halo_ms": t_halo * 1e3,
            "t_allgather_ms": t_ag * 1e3,
            "efficiency": t_comp / t_total,
            "speedup": step_time_s / t_total,
        })
    return rows


def predict_spatial_inference_scaling(image_hw, halo: int, cin: int,
                                      dense_time_s: float,
                                      n_list=(2, 4, 8),
                                      itemsize: int = 4,
                                      link_gbps: float = H100_NVLINK_GBPS
                                      ) -> list:
    """Latency table for row-sharded (halo-exchange) single-image
    inference (``segtpu_torch/parallel/spatial.py``): each of ``n`` ranks
    forwards an ``(H/n + 2·halo, W)`` band after one halo exchange of
    ``halo·W·cin·itemsize`` bytes per direction (both directions
    serialised here); band compute ∝ band pixels.

    Returns [{n, t_band_ms, t_halo_ms, latency_ms, speedup,
    efficiency}, ...] including the n=1 dense row.
    """
    h, w = image_hw
    rows = []
    for n in (1,) + tuple(n_list):
        band_px = (h / n + (2 * halo if n > 1 else 0)) * w
        t_band = dense_time_s * band_px / (h * w)
        t_halo = (2 * halo * w * cin * itemsize / link_gbps
                  if n > 1 else 0.0)
        latency = t_band + t_halo
        rows.append({
            "n": n,
            "t_band_ms": t_band * 1e3,
            "t_halo_ms": t_halo * 1e3,
            "latency_ms": latency * 1e3,
            "speedup": dense_time_s / latency,
            "efficiency": dense_time_s / latency / n,
        })
    return rows
