"""The benchmark's arithmetic: the card's peaks, the operations and bytes of
each hand-written kernel from its launch shape, least times, the FLOPs of
the plain reference's work, and quartile spreads.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at its
700 W limit: 989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores,
3.35 TB/s of HBM. A kernel's least time is the larger of its operations over
the peak and its bytes over the memory rate, each input byte read once and
each output byte written once.
"""

from __future__ import annotations

import re
import statistics
from typing import Dict, Iterable, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# demangled or mangled symbols of the program's kernels, in an anonymous
# namespace of their .cu file
_OWN = r"(?:anonymous namespace\)|_GLOBAL__N_)"
KERNEL_NAMES = {
    "b1": re.compile(_OWN + r".*(?<!b)(?<!bwd_)fwd_kernel"),
    "b2": re.compile(_OWN + r".*bwd_dq_kernel"),
    "b4": re.compile(_OWN + r".*bwd_dkv_kernel"),
    "b5": re.compile(_OWN + r".*dual_cross_attention_kernel"),
}


def kernel_of(name: str):
    """Which of B1, B2, B4, B5 a device kernel's name is, or None."""
    for key, pat in KERNEL_NAMES.items():
        if pat.search(name):
            return key
    return None


def least_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def _numel(shape: Sequence[int]) -> int:
    """Elements of a stored tensor's shape; 0 for no tensor (``()``)."""
    if not shape:
        return 0
    n = 1
    for s in shape:
        n *= int(s)
    return n


def flash_fwd_cost(q: Sequence[int], k: Sequence[int], bias: Sequence[int] = ()) -> Tuple[float, float]:
    """B1: (operations, bytes) of softmax(q k^T + bias) v over [B, H, S, D]
    in bf16: q, k, v and the bias (fp32, as stored) read, o and the fp32
    log-sum-exp written."""
    b, h, sq, d = q
    sk = k[2]
    flops = 4.0 * b * h * sq * sk * d
    nbytes = 2 * (2 * b * h * sq * d + 2 * b * h * sk * d) + 4 * b * h * sq
    return flops, nbytes + 4 * _numel(bias)


def flash_bwd_cost(q: Sequence[int], k: Sequence[int], bias: Sequence[int] = ()) -> Tuple[float, float]:
    """B2 with B4: the backward of B1 without the probabilities stored: S
    recomputed once, dP, dV, dQ, dK (5 products of 2 B H Sq Sk D); q, k, v,
    o, dO and the log-sum-exp read, dQ, dK, dV written."""
    b, h, sq, d = q
    sk = k[2]
    flops = 10.0 * b * h * sq * sk * d
    nbytes = 2 * (3 * b * h * sq * d + 2 * b * h * sk * d) + 4 * b * h * sq \
        + 2 * (b * h * sq * d + 2 * b * h * sk * d)
    return flops, nbytes + 4 * _numel(bias)


def dual_cost(q: Sequence[int], kt: Sequence[int], ki: Sequence[int],
              bias: Sequence[int] = ()) -> Tuple[float, float]:
    """B5: two attentions of one query set, over text keys and IP keys (the
    fp32 bias on the IP scores); q, both key and value sets and the bias read,
    both outputs written."""
    b, h, sq, d = q
    keys = kt[2] + ki[2]
    flops = 4.0 * b * h * sq * d * keys
    nbytes = 2 * (3 * b * h * sq * d + 2 * b * h * keys * d)
    return flops, nbytes + 4 * _numel(bias)


def roofline_pct(least: Iterable[float], device_s: float):
    """Sum of least times over the kernel's summed device time, in %; None
    when the kernel did not run."""
    total = sum(least)
    if device_s <= 0 or total <= 0:
        return None
    return 100.0 * total / device_s


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's ``statistics.quantiles``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def reference_flops(fn, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` by ``FlopCounterMode`` (matmuls,
    convolutions and their backward), run wherever its tensors are (the meta
    device costs no arithmetic)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
