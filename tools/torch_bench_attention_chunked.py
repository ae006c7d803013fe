#!/usr/bin/env python3
"""Kernel B7 (k-chunked online-softmax attention) beside B1 on one NVIDIA GPU.

    python3 tools/torch_bench_attention_chunked.py

Run from the root of the repository. The port of
``tools/bench_attention_chunked.py``: at its three bf16 self-attention
shapes, (2,10,4096,64), (2,20,1024,64) and (2,10,16384,64), with q = k = v
as the JAX script has them, it first holds ``chunked_attention`` (the JAX
default chunk of 512 keys, and every other chunk it times) within 2e-2 of B1
(``flash_attention``), and where there are at most 1024 keys both B1 and B7
within 2e-2 of the exact fp32 oracle. Then one line a shape: the JAX
script's row (B1's time, then B7's at chunks 256, 512 and 1024, and at 64
and 128, which the card takes and the TPU script did not try), with
``F.scaled_dot_product_attention``'s time on the same inputs and the bound.
A chunk the kernel refuses prints ``ERR(...)`` with its reason. Times are
medians of CUDA-event passes (``chip_smoke.cuda_ms``). Then the card's
``nvidia-smi`` line and ``{"ok": true}`` (``{"ok": false}`` and exit code 1
where a check fails). It needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (timing, bound and output of the smoke run)

SHAPES = [("lvl1", (2, 10, 4096, 64)), ("lvl2", (2, 20, 1024, 64)),
          ("16k", (2, 10, 16384, 64))]
CHUNKS = (256, 512, 1024, 64, 128)
MAX_ERR = 2e-2


def main() -> int:
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import chunked_attention as ca
    from diffsensei_tpu_torch.ops import flash_attention as fa
    from diffsensei_tpu_torch.ops.attention import attention_ref

    if not torch.cuda.is_available():
        print("torch_bench_attention_chunked: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    ok = True
    for name, shape in SHAPES:
        q = torch.randn(shape, generator=gen, device=device).bfloat16()
        b1 = fa.flash_attention(q, q, q)[0]
        got = ca.chunked_attention(q, q, q)
        row = dict(name=f"{name} {shape}", maxerr_vs_b1=(got.float() - b1.float()).abs().max().item())
        ok &= row["maxerr_vs_b1"] <= MAX_ERR
        if shape[2] <= 1024:   # both kernels against the exact oracle once
            exact = attention_ref(q.float(), q.float(), q.float())
            for label, out in (("b1", b1), ("chunked", got)):
                row[f"maxerr_{label}_vs_exact"] = (out.float() - exact).abs().max().item()
                ok &= row[f"maxerr_{label}_vs_exact"] <= MAX_ERR
        row["b1_ms"] = cs.cuda_ms(lambda: fa.flash_attention(q, q, q))
        row["sdpa_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, q, q))
        for chunk in CHUNKS:
            try:
                out = ca.chunked_attention(q, q, q, chunk=chunk)
            except ValueError as e:
                row[f"chunk{chunk}"] = f"ERR({type(e).__name__}: {e})"
                continue
            err = (out.float() - b1.float()).abs().max().item()
            ok &= err <= MAX_ERR
            row[f"chunk{chunk}_ms"] = cs.cuda_ms(lambda: ca.chunked_attention(q, q, q, chunk=chunk))
            row[f"chunk{chunk}_maxerr_vs_b1"] = err
        b, h, s, d = shape
        row.update(cs.bound(2 * b * h * d * 4 * s, 4 * b * h * s * s * d))
        cs.emit(row)
        print(" | ".join([row["name"], f"maxerr {row['maxerr_vs_b1']:.2e}",
                          f"flash {row['b1_ms']:.4f}", f"sdpa {row['sdpa_ms']:.4f}"]
                         + [f"chunk{c} " + (f"{row[f'chunk{c}_ms']:.4f}" if f"chunk{c}_ms" in row
                                            else row[f"chunk{c}"]) for c in CHUNKS]
                         + [f"bound {row['bound_ms']:.4f} ms"]), flush=True)
        del q, b1, got
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
