"""Static-shape traffic and FLOP accounting for the solve.

Counterpart of ``cuda_knearests_tpu/utils/roofline.py``, with the
reference's counting law.  Every plan the engine builds has static shapes,
so the bytes a solve must move and the distance FLOPs it must execute are
computable on the host without instrumenting the kernels; divided by a
measured solve's seconds they give achieved GB/s and GFLOP/s, and against
the card's peaks (``utils/devinfo.DEVICE_PEAKS``) a roofline share.

Traffic model (per solve call; 4-byte f32/i32 elements), counted on the
PADDED static shapes of the plan:

- HBM: the kernel's inputs read once (per-axis coordinate blocks qx/qy/qz
  + qid and cx/cy/cz + cid: 4*(qcap + ccap) elements per supercell) and
  its outputs written once (k distances + k ids per padded query slot),
  plus the epilogue's gather of those outputs into the (n, k) result (read
  + write 2*n*k elements each).
- On-chip (the class kernels, route 'kernel'): the kernel's staged working
  set in shared memory and registers, per query row
    one-stage: k * ccap              (k min-and-mask sweeps of the row)
    blocked:   ccap * m + k * g * m  (per-block top m, then a k-pass over
                                      the (g * m) survivor pool)
  times 4 bytes, times qcap * n_sc.  No public peak pins that rate, so it
  is reported as achieved GB/s only, with no share of any peak.
- Routes that materialize the distance tile in device memory ('streamed',
  'mxu', the legacy 'xla' scan): one write and one read of qcap * ccap
  elements per supercell.
- FLOPs: 8 per (query slot, candidate slot) pair: 3 subtractions, 3
  multiplications, 2 additions, as the CUDA reference's accumulation.

These counts include pad slots, so they bound a solve from below only as
loosely as the plan pads: ``chip_smoke.py``'s kernel bounds count the real
pairs and the real bytes instead (``PERF.md`` section 6 compares the two).

The port's routes map onto the reference's: the adaptive class route
'kernel' (the reference's 'pallas') counts by the kernel law; the legacy
pack (``ops/cuda_solve.build_pack``) is one kernel class; the legacy 'xla'
route is the plain-torch scan ``ops/solve.chunk_best``.  FLOP/s are held
against the card's FP32 peak (the kernels' f32 arithmetic runs on the CUDA
cores); ``roofline_flops_precision`` says which peak, and
``roofline_peak_source`` its provenance.
"""

from __future__ import annotations

from typing import Optional

from .devinfo import current_device_kind, device_peaks

_BYTES = 4  # f32 coords/dists, i32 ids
_FLOPS_PER_PAIR = 8
_KEYS = ("hbm_read", "hbm_write", "pairs", "flops", "onchip")


def _class_counts(n_sc: int, qcap: int, ccap: int, route: str, k: int,
                  kernel: str) -> dict:
    """Static counts for one class-shaped launch (the legacy pack is one
    class with route 'kernel')."""
    from ..config import blocked_topm, resolve_kernel

    pairs = n_sc * qcap * ccap
    out = {
        # inputs: 3 coordinate axes + 1 id block for each side, read once
        "hbm_read": n_sc * 4 * (qcap + ccap) * _BYTES,
        # outputs: k distances + k ids per padded query slot, written once
        "hbm_write": n_sc * qcap * k * 2 * _BYTES,
        "pairs": pairs,
        "flops": pairs * _FLOPS_PER_PAIR,
        "onchip": 0,
    }
    if route == "kernel":
        if resolve_kernel(kernel, k, ccap) == "blocked":
            m = blocked_topm(k, ccap)
            per_query = ccap * m + k * (ccap // 128) * m
        else:
            per_query = k * ccap
        out["onchip"] = n_sc * qcap * per_query * _BYTES
    else:
        # the distance tile in device memory: one write and one read
        out["hbm_read"] += pairs * _BYTES
        out["hbm_write"] += pairs * _BYTES
    return out


def _accumulate(rows: list[dict], n_points: int, k: int) -> dict:
    tot = {key: sum(r[key] for r in rows) for key in _KEYS}
    # epilogue: gather the raw per-slot outputs into the (n, k) result
    # (read the gathered rows, write neighbours + distances)
    epi = 2 * n_points * k * 2 * _BYTES
    tot["hbm_read"] += epi // 2
    tot["hbm_write"] += epi // 2
    tot["hbm_total"] = tot["hbm_read"] + tot["hbm_write"]
    return tot


def adaptive_traffic(plan, k: int, kernel: str) -> dict:
    """Per-solve static counts for an AdaptivePlan (all classes)."""
    rows = [_class_counts(cp.n_sc, cp.qcap, cp.ccap, cp.route, k, kernel)
            for cp in plan.classes]
    return _accumulate(rows, plan.n_points, k)


def pack_traffic(pack, k: int, kernel: str) -> dict:
    """Per-solve static counts for the legacy pack (one kernel class)."""
    rows = [_class_counts(pack.s_total, pack.qcap, pack.ccap, "kernel", k,
                          kernel)]
    return _accumulate(rows, int(pack.inv_flat.shape[0]), k)


def xla_plan_traffic(plan, n_points: int, k: int) -> dict:
    """Per-solve static counts for the legacy plain-torch scan."""
    rows = [_class_counts(plan.n_chunks * plan.batch, plan.qcap, plan.ccap,
                          "xla", k, "kpass")]
    return _accumulate(rows, n_points, k)


def problem_traffic(problem) -> Optional[dict]:
    """Static traffic counts for a prepared single-device KnnProblem, or
    None when the engine has no device plan to account (oracle backend,
    or an empty cloud)."""
    cfg = problem.config
    if cfg.backend == "oracle":
        return None
    k, kernel = cfg.k, cfg.effective_kernel()
    if problem.aplan is not None:
        return adaptive_traffic(problem.aplan, k, kernel)
    if problem.pack is not None:
        return pack_traffic(problem.pack, k, kernel)
    if problem.plan is not None:
        return xla_plan_traffic(problem.plan, problem.grid.n_points, k)
    return None


def sharded_traffic(sp) -> Optional[dict]:
    """Static traffic counts summed over a ShardedKnnProblem's slab plans
    (each an adaptive class schedule over its halo-extended window; the
    halo exchange is a prepare-time cost, not part of the solve)."""
    cfg = sp.config
    k, kernel = cfg.k, cfg.effective_kernel()
    rows = [_class_counts(cp.n_sc, cp.qcap, cp.ccap, cp.route, k, kernel)
            for plan in sp.chip_plans for cp in plan.classes]
    if not rows:
        return None
    return _accumulate(rows, sp.n_points, k)


def roofline_fields(traffic: Optional[dict], solve_s: float,
                    platform: str, n_devices: int = 1,
                    device_kind: Optional[str] = None) -> dict:
    """Row fields from static counts and measured seconds.

    The peaks resolve from ``devinfo.DEVICE_PEAKS`` by the device's name
    (probed from torch when the probe's platform is ``platform``, 'cuda'
    or 'cpu'; an explicit ``device_kind`` wins), falling back by platform
    (stamped ``assumed``).  Every share names the peak it was held against
    and its provenance.  ``n_devices``: devices the traffic was spread
    over at once -- their aggregate rate is held against n_devices times
    one device's peak."""
    if not traffic or solve_s <= 0:
        return {}
    out = {
        "moved_hbm_gb": round(traffic["hbm_total"] / 1e9, 4),
        "achieved_hbm_gbps": round(traffic["hbm_total"] / solve_s / 1e9, 2),
        "dist_gflop": round(traffic["flops"] / 1e9, 3),
        "achieved_gflops": round(traffic["flops"] / solve_s / 1e9, 2),
        "traffic_model": "static-shape lower bound (utils/roofline.py)",
    }
    if traffic.get("onchip"):
        out["modeled_onchip_gb"] = round(traffic["onchip"] / 1e9, 4)
        out["achieved_onchip_gbps"] = round(
            traffic["onchip"] / solve_s / 1e9, 2)
    if device_kind is None:
        probed_kind, probed_platform = current_device_kind()
        # adopt the live probe only when it describes the platform this
        # measurement claims: a CPU row must not take the card's name
        if probed_kind is not None and probed_platform == platform:
            device_kind = probed_kind
    if device_kind:
        out["device_kind"] = device_kind
    peaks = device_peaks(device_kind, platform)
    scale = max(1, n_devices)
    if peaks and peaks.get("hbm_gbps"):
        out["pct_hbm_roofline"] = round(
            100.0 * out["achieved_hbm_gbps"] / (peaks["hbm_gbps"] * scale),
            2)
        out["roofline_peak_gbps"] = peaks["hbm_gbps"]
        out["roofline_peak_source"] = (
            f"{peaks['entry']}"
            + (" (assumed from platform)" if peaks.get("assumed") else "")
            + f": {peaks['basis']}")
        if n_devices > 1:
            out["roofline_basis"] = f"aggregate over {n_devices} devices"
    if peaks and peaks.get("peak_tflops_fp32"):
        out["pct_flops_roofline"] = round(
            100.0 * (out["achieved_gflops"] / 1e3)
            / (peaks["peak_tflops_fp32"] * scale), 4)
        out["roofline_peak_tflops"] = peaks["peak_tflops_fp32"]
        out["roofline_flops_precision"] = "fp32"
    return out
