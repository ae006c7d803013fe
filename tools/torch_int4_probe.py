#!/usr/bin/env python3
"""Kernel B6 (int4 decode matmul) beside ways of streaming the same bytes, on
one NVIDIA GPU.

    python3 tools/torch_int4_probe.py

Run from the root of the repository. At each T = 1 shape of the SEED-X
agent's decode (``chip_smoke.INT4_CASES``), with fp32 x as the served path
passes it and cold weights (``chip_smoke.cuda_ms``), one JSON line holds:

* B6's time with the cluster it picks and with 1, 2, 4, 8 and 16 blocks a
  cluster (``int4_matmul._decode_cuda``'s ``cluster``), each agreeing with
  the plain twin (relative Frobenius norm);
* the yardsticks of ``tools/int4_stream_probe.cu``, which read the packed
  bytes once with no arithmetic: B6's walk over the rows (128-byte strips,
  4 warps a block, 4 chunks in flight a warp) with register loads, with
  cp.async and with bulk copies onto an mbarrier, at B6's picked split and at
  16; and one contiguous read of the same bytes;
* the bound (bytes over 3.35 TB/s).

Then B6 on a one-group input (in = 128): its time when there is nearly
nothing to stream. Then the card's ``nvidia-smi`` line and ``{"ok": true}``
(``{"ok": false}`` and exit code 1 if B6 disagrees with its twin).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (shapes, timing and bound of the smoke run)


def probe_library() -> ctypes.CDLL:
    from diffsensei_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "int4_stream_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = ROOT / "tools" / "int4_stream_probe.cu"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.probe_contiguous.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_strips.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def main() -> int:
    import torch
    from diffsensei_tpu_torch.ops import int4_matmul as i4

    if not torch.cuda.is_available():
        print("torch_int4_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    lib = probe_library()
    sink = torch.zeros(4, dtype=torch.int32, device=device)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=device).manual_seed(4)
    ok = True
    shapes = [c for c in cs.INT4_CASES if c[0] == 1] + [(1, 128, 5120), (1, 128, 32330)]
    for tokens, in_f, features in shapes:
        padded = i4.padded_features(features, in_f, 128)
        out2 = padded // 2
        wbytes = in_f * out2 + (in_f // 128) * padded * 4
        copies = min(64, -(-256 * 2**20 // wbytes))
        weights = [(torch.randint(0, 256, (in_f, out2), generator=gen, device=device,
                                  dtype=torch.uint8),
                    (torch.rand((in_f // 128, padded), generator=gen, device=device) + 0.5)
                    / (4.61 * in_f ** 0.5)) for _ in range(copies)]
        x = torch.randn((tokens, in_f), generator=gen, device=device)
        packed, scale = weights[0]
        twin = i4.int4_decode_fallback(x.bfloat16().float(), packed, scale)
        picked = i4.layout(tokens, torch.float32, out2)["cluster"]
        row = dict(shape=[tokens, in_f, features], picked_cluster=picked, b6_us={}, rel={},
                   bound_us=cs.bound(wbytes + 4 * in_f + 4 * padded, 0)["bound_ms"] * 1e3)
        for cluster in (0, 1, 2, 4, 8, 16):
            y = i4._decode_cuda(x, packed, scale, cluster)
            torch.cuda.synchronize()
            row["rel"][cluster] = ((y - twin).norm() / twin.norm()).item()
            ok &= row["rel"][cluster] < 2e-2
            row["b6_us"][cluster] = cs.cuda_ms(
                [lambda q=q, s=s, c=cluster: i4._decode_cuda(x, q, s, c) for q, s in weights]) * 1e3
        if in_f > 128:
            for how, name in enumerate(("registers", "cp_async", "bulk")):
                for ranks in sorted({picked, 16}):
                    row[f"{name}_us@{ranks}"] = cs.cuda_ms(
                        [lambda q=q, h=how, r=ranks: lib.probe_strips(
                            h, q.data_ptr(), in_f, out2, r, sink.data_ptr(), stream())
                         for q, _ in weights]) * 1e3
            row["contiguous_us"] = cs.cuda_ms(
                [lambda q=q: lib.probe_contiguous(q.data_ptr(), in_f * out2, 1056,
                                                  sink.data_ptr(), stream())
                 for q, _ in weights]) * 1e3
        cs.emit(row)
        del weights
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
