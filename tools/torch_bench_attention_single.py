#!/usr/bin/env python3
"""Kernel B8 (single-pass exact-softmax attention) beside B1 on one NVIDIA GPU.

    python3 tools/torch_bench_attention_single.py

Run from the root of the repository. The port of
``tools/bench_attention_single.py``: at its three bf16 self-attention
shapes, (2,10,4096,64), (2,20,1024,64) and (2,10,16384,64), with q = k = v
as the JAX script has them, one line a shape: the JAX script's row
(``single_pass_attention`` at block_q 512, 256 and 128, or ``ERR(...)`` with
the reason where the kernel refuses the shape; its q tile is 64 rows at
every block_q, which only shapes the TPU's grid and the twin's blocks), B1's
time, ``F.scaled_dot_product_attention``'s on the same inputs, the bound,
then the max error against the exact fp32 oracle and against B1, each within
2e-2. The oracle is built only where the kernel computes (at most 4096 keys,
1.3 GB of fp32 scores), never at 16384. Times are medians of CUDA-event
passes (``chip_smoke.cuda_ms``). Then the card's ``nvidia-smi`` line and
``{"ok": true}`` (``{"ok": false}`` and exit code 1 where a check fails). It
needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (timing, bound and output of the smoke run)

SHAPES = [("lvl1 self", (2, 10, 4096, 64)), ("lvl2 self", (2, 20, 1024, 64)),
          ("16k self", (2, 10, 16384, 64))]
BLOCK_QS = (512, 256, 128)
MAX_ERR = 2e-2


def main() -> int:
    import torch
    import torch.nn.functional as F
    from diffsensei_tpu_torch.ops import flash_attention as fa
    from diffsensei_tpu_torch.ops import single_pass_attention as sp
    from diffsensei_tpu_torch.ops.attention import attention_ref

    if not torch.cuda.is_available():
        print("torch_bench_attention_single: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    ok = True
    for name, shape in SHAPES:
        q = torch.randn(shape, generator=gen, device=device).bfloat16()
        row = dict(name=f"{name} {shape}")
        for bq in BLOCK_QS:
            if bq > shape[2]:
                continue
            try:
                sp.single_pass_attention(q, q, q, block_q=bq)
            except ValueError as e:
                row[f"single{bq}"] = f"ERR({type(e).__name__}: {e})"
                continue
            row[f"single{bq}_ms"] = cs.cuda_ms(lambda: sp.single_pass_attention(q, q, q, block_q=bq))
        row["b1_ms"] = cs.cuda_ms(lambda: fa.flash_attention(q, q, q))
        row["sdpa_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, q, q))
        b, h, s, d = shape
        row.update(cs.bound(2 * b * h * d * 4 * s, 4 * b * h * s * s * d))
        try:
            got = sp.single_pass_attention(q, q, q, block_q=min(512, s))
        except ValueError as e:
            row["maxerr"] = f"ERR({type(e).__name__}: {e})"
        else:
            exact = attention_ref(q.float(), q.float(), q.float())
            b1 = fa.flash_attention(q, q, q)[0]
            row["maxerr"] = (got.float() - exact).abs().max().item()
            row["maxerr_vs_b1"] = (got.float() - b1.float()).abs().max().item()
            ok &= max(row["maxerr"], row["maxerr_vs_b1"]) <= MAX_ERR
            del got, exact, b1
        cs.emit(row)
        cells = [row["name"]]
        for bq in BLOCK_QS:
            if f"single{bq}_ms" in row:
                cells.append(f"single[{bq}] {row[f'single{bq}_ms']:.4f}")
            elif f"single{bq}" in row:
                cells.append(f"single[{bq}] {row[f'single{bq}']}")
        cells += [f"flash {row['b1_ms']:.4f} ms", f"sdpa {row['sdpa_ms']:.4f} ms",
                  f"bound {row['bound_ms']:.4f} ms",
                  "maxerr " + (f"{row['maxerr']:.3e}" if isinstance(row["maxerr"], float)
                               else row["maxerr"])]
        print(" | ".join(cells), flush=True)
        del q
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
