"""Device discovery, the property dump, and the per-device peaks table.

Counterpart of ``cuda_knearests_tpu/utils/devinfo.py``.  Parity with the
CUDA reference's ``printDevProp`` (``test_knearests.cu:83-115``): prints
every CUDA device torch sees with the properties that matter for this
workload (name, memory, SM count, compute capability, L2 size).

:data:`DEVICE_PEAKS` is the one source of roofline peak constants
(``utils/roofline.py`` reads it): public peak HBM bandwidth and FLOP/s per
device kind, matched by a substring of the device's name, with a nominal
CPU entry.  Every entry carries a ``basis`` string naming where its numbers
come from: a pct-of-peak figure is only as good as its peak's provenance.
The table states no TPU numbers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

#: Public peak table, keyed by a canonical entry name; ``match`` holds
#: lowercased substrings of the device name that select the entry.
#: ``peak_tflops`` is the tensor-core peak at ``flops_precision``;
#: ``peak_tflops_fp32`` the FP32 rate of the CUDA cores, which the grid
#: route's f32 kernels run on.  The H100 entry matches the SXM5 part
#: (``torch.cuda.get_device_name()`` = "NVIDIA H100 80GB HBM3") and not the
#: PCIe or NVL parts, whose peaks differ.  The CPU entry is a NOMINAL host
#: memory figure, so CPU rows still render an order-of-magnitude roofline;
#: its basis says exactly that.
DEVICE_PEAKS: Dict[str, Dict[str, Any]] = {
    "h100-sxm": {"match": ("h100 80gb hbm3", "h100 sxm"),
                 "hbm_gbps": 3350.0, "peak_tflops": 989.0,
                 "flops_precision": "bf16", "peak_tflops_fp32": 67.0,
                 "basis": "NVIDIA H100 Tensor Core GPU datasheet, SXM5 "
                          "column (dense, no sparsity; at the 700 W "
                          "power limit)"},
    "cpu": {"match": ("cpu", "host"),
            "hbm_gbps": 51.2, "peak_tflops": None,
            "flops_precision": None, "peak_tflops_fp32": None,
            "basis": "nominal 4-channel DDR4-3200 host (CPU: "
                     "order-of-magnitude, not a measured claim)"},
}

#: Platform fallback when the device name matches no entry: an unnamed
#: CUDA device is assumed to be the H100 SXM5 the port targets (stamped
#: ``assumed`` so the provenance is visible), the CPU takes the nominal
#: CPU entry.
_PLATFORM_DEFAULT = {"cuda": "h100-sxm", "cpu": "cpu"}


def device_peaks(device_kind: Optional[str] = None,
                 platform: Optional[str] = None) -> Optional[dict]:
    """The peaks entry for a device name (substring match), falling back
    by platform ('cuda' or 'cpu'); None when neither resolves.  The
    returned dict carries ``entry`` (the table key) and ``assumed=True``
    on platform fallbacks."""
    kind = (device_kind or "").lower()
    if kind:
        for name, ent in DEVICE_PEAKS.items():
            if any(m in kind for m in ent["match"]):
                return {"entry": name,
                        **{k: v for k, v in ent.items() if k != "match"}}
    key = _PLATFORM_DEFAULT.get((platform or "").lower())
    if key is not None:
        ent = DEVICE_PEAKS[key]
        return {"entry": key, "assumed": True,
                **{k: v for k, v in ent.items() if k != "match"}}
    return None


def current_device_kind() -> Tuple[Optional[str], Optional[str]]:
    """(device name, 'cuda') of the current CUDA device, or (None, None)
    where no CUDA device is reachable.  Never raises: a stamp must not
    fail the run it describes."""
    try:
        if not torch.cuda.is_available():
            return None, None
        return str(torch.cuda.get_device_name()), "cuda"
    except Exception:  # noqa: BLE001 -- a broken CUDA install must not fail a stamp
        return None, None


def device_properties() -> List[Dict[str, Any]]:
    """One dict per visible CUDA device (none without a card): id, name,
    total memory, SM count, compute capability, L2 size and the bytes
    torch's allocator holds in tensors on it."""
    props = []
    if not torch.cuda.is_available():
        return props
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        entry: Dict[str, Any] = {
            "id": i,
            "platform": "cuda",
            "device_kind": p.name,
            "memory_limit_bytes": int(p.total_memory),
            "multiprocessor_count": int(p.multi_processor_count),
            "compute_capability": f"{p.major}.{p.minor}",
            "memory_in_use_bytes": int(torch.cuda.memory_allocated(i)),
        }
        l2 = getattr(p, "L2_cache_size", None)
        if l2 is not None:
            entry["l2_cache_bytes"] = int(l2)
        props.append(entry)
    return props


def print_device_properties() -> None:
    """Human-readable dump (the CUDA reference's ``printDevProp``)."""
    devs = device_properties()
    print(f"There are {len(devs)} CUDA devices (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    for p in devs:
        print(f"  device {p['id']}: {p['device_kind']} [{p['platform']}]")
        for key in ("memory_limit_bytes", "memory_in_use_bytes",
                    "multiprocessor_count", "compute_capability",
                    "l2_cache_bytes"):
            if key in p:
                print(f"    {key}: {p[key]}")
