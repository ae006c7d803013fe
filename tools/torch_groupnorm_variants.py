#!/usr/bin/env python3
"""Where kernel B3's time goes, and the cluster design beside it, on one
NVIDIA GPU.

    python3 tools/torch_groupnorm_variants.py

Run from the root of the repository. A variant is a textual edit of the
source, compiled with the port's nvcc flags into a temporary directory (the
checkout is left as it is) and swapped in for the sound library in turn. The
resident kernel's variants return early, after one phase each (the slab's
load, the threads' passes over it, the block's partials, the grid barrier,
the merge of the partials), or drop the SiLU or the stores of the normalize phase; the
streaming route's drops launch 2's merge. Their results are wrong and only
their times are read: one JSON line a (variant, shape) with the device time
of each kernel a call (``torch.profiler`` over 20 calls on the same input,
so it is warm in L2) and the time a call cold (``chip_smoke.cuda_ms`` over
``chip_smoke.cold_calls``).

Then the design with thread-block clusters (``tools/groupnorm_cluster_probe.cu``:
a cluster of up to 16 blocks holds a strip of whole groups in shared memory,
the blocks' statistics meet through distributed shared memory) at the shapes
in ``CLUSTER_SHAPES``, at every strip width (groups a strip) and cluster size
whose slabs fit a block's shared memory, with vector stores and with bulk
(TMA) stores: one JSON line each with its time cold beside the shipped
kernel's, the clusters a call and the clusters the card holds at once, each
held to the shipped kernel's tolerance of the plain twin and bit-equal over
two calls. Last line ``{"ok": true}`` (false, and exit code 1, if a cluster
variant disagrees). Needs a CUDA device; imports torch only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the cases and timers of the smoke run)

RET = "  if (hw > 0) return;\n"
EDITS = {
    "sound": [],
    "after_load": [("  for (int e = 0; e < EPV; ++e) ks[e] = shift[(col0 + e) / cg];\n",
                    "  for (int e = 0; e < EPV; ++e) ks[e] = shift[(col0 + e) / cg];\n" + RET)],
    "after_passes": [("  __syncthreads();\n  merge_entries(ent_n, ent_mean, ent_m2, P, c, cg, groups,",
                      "  __syncthreads();\n" + RET
                      + "  merge_entries(ent_n, ent_mean, ent_m2, P, c, cg, groups,")],
    "after_stats": [("  // every block's partials written (the grid barrier orders them before the\n",
                     RET + "  // every block's partials written (the grid barrier orders them before the\n")],
    "after_barrier": [("  merge_partials(part + (size_t)b * slabs * groups, slabs, groups, eps, coef);\n",
                       RET)],
    "after_merge": [("  __syncthreads();\n  if (!active) return;\n\n  // normalize",
                     "  __syncthreads();\n" + RET + "\n  // normalize")],
    "no_silu": [("    for (int e = 0; e < EPV; ++e) v[e] = silu(fmaf((v[e] - ks[e]) - mu[e], a[e], sh[e]));"
                 "\n    store_vec<T, VEC>(yp",
                 "    for (int e = 0; e < EPV; ++e) v[e] = fmaf((v[e] - ks[e]) - mu[e], a[e], sh[e]);"
                 "\n    store_vec<T, VEC>(yp")],
    "no_stores": [("    store_vec<T, VEC>(yp + (size_t)i * P * c, v);\n",
                   "    if (v[0] == 12345.0f) store_vec<T, VEC>(yp + (size_t)i * P * c, v);\n")],
    "streaming_no_merge": [
        ("  merge_partials(part + ((size_t)b * strips + strip) * slabs * ng, slabs, ng, eps, coef);\n",
         "  if (threadIdx.x < ng) coef[2 * threadIdx.x] = 0.0f, coef[2 * threadIdx.x + 1] = 1.0f;\n")],
}
RESIDENT = [((2, 128, 128, 320), "bfloat16"), ((2, 32, 32, 1280), "bfloat16"),
            ((1, 96, 96, 512), "float32")]
STREAMING = [((2, 128, 128, 640), "bfloat16"), ((1, 1024, 1024, 128), "float32")]
# the cluster design's shapes: R1's three commonest UNet shapes, the UNet's
# largest group (983 KB at 960 channels) and the VAE's 128² level (1.05 MB)
CLUSTER_SHAPES = [((2, 128, 128, 320), "bfloat16", 1e-5), ((2, 64, 64, 640), "bfloat16", 1e-5),
                  ((2, 32, 32, 1280), "bfloat16", 1e-5), ((2, 128, 128, 960), "bfloat16", 1e-5),
                  ((1, 128, 128, 512), "float32", 1e-6)]


def kernel_us(fn, calls: int = 20) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("<")[0][:24]: e.self_device_time_total / e.count
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


def cluster_library() -> ctypes.CDLL:
    from diffsensei_tpu_torch.ops import _build

    src = ROOT / "tools" / "groupnorm_cluster_probe.cu"
    out = _build.BUILD_DIR / "groupnorm_cluster_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    cs.emit({"cluster_ptxas": [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                               if "registers" in ln or "spill" in ln]})
    lib = ctypes.CDLL(str(out))
    lib.gn_cluster.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
                               + [ctypes.c_void_p] * 3)
    lib.gn_cluster.restype = ctypes.c_int
    return lib


def cluster_design(device) -> bool:
    """The cluster design at CLUSTER_SHAPES beside the shipped kernel; True
    when every variant agrees with the twin and repeats its bits."""
    import torch
    from diffsensei_tpu_torch.ops import groupnorm as gn

    lib = cluster_library()
    gen = torch.Generator(device=device).manual_seed(1)
    ok = True
    for shape, dtype_name, eps in CLUSTER_SHAPES:
        x, scale, bias = cs.gn_inputs(shape, dtype_name, gen, device)
        b, h, w, c = shape
        es = x.element_size()
        want = gn.groupnorm_silu_ref(x, scale, bias, 32, eps).float()
        shipped = cs.cuda_ms(cs.cold_calls(lambda x: gn.groupnorm_silu(x, scale, bias, 32, eps), x))
        bound = cs.bound(2 * x.numel() * es + 2 * c * es, 10 * x.numel())["bound_ms"]
        for ng in (1, 2, 4, 8, 16, 32):
            for cluster in (2, 4, 8, 16):
                for bulk in (0, 1):
                    vec, active = ctypes.c_int(), ctypes.c_int()

                    def call(x, query=False, ng=ng, cluster=cluster, bulk=bulk, vec=vec,
                             active=active):
                        y = torch.empty_like(x)
                        err = lib.gn_cluster(
                            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                            int(es == 4), int(es == 4), int(es == 4), b, h * w, c, 32, ng,
                            cluster, bulk, eps, torch.cuda.current_stream().cuda_stream,
                            ctypes.byref(vec), ctypes.byref(active) if query else None)
                        return y if err == 0 else err
                    got = call(x, query=True)
                    if isinstance(got, int):
                        # cudaErrorInvalidValue: a layout it does not take (the
                        # slab exceeds a block's shared memory; a row piece
                        # bulk copies cannot move)
                        if got != 1:
                            raise RuntimeError(f"gn_cluster failed: cudaError {got}")
                        continue
                    again = call(x)
                    torch.cuda.synchronize()
                    err = (got.float() - want).abs().max().item()
                    agrees = (torch.allclose(got.float(), want, rtol=1e-2, atol=1e-2)
                              if es == 2 else err <= 1e-4) and torch.equal(got, again)
                    ok &= agrees
                    clusters = b * 32 // ng
                    ms = cs.cuda_ms(cs.cold_calls(call, x))
                    cs.emit(dict(design="cluster", shape=list(shape), dtype=dtype_name,
                                 groups_per_strip=ng, piece_bytes=ng * (c // 32) * es,
                                 cluster=cluster, bulk_stores=bool(bulk), vec=vec.value,
                                 clusters=clusters, clusters_at_once=active.value,
                                 waves=clusters / max(active.value, 1), max_abs_err=err,
                                 ok=agrees, ms=ms, shipped_ms=shipped, bound_ms=bound,
                                 vs_shipped=ms / shipped))
                    del got, again
        del x, want
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    import torch
    from diffsensei_tpu_torch.ops import _build, groupnorm as gn

    if not torch.cuda.is_available():
        print("torch_groupnorm_variants: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    source = (_build.CSRC / "groupnorm_silu.cu").read_text()
    for name, edits in EDITS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the edit's text occurs {text.count(old)} times")
            text = text.replace(old, new)
        with tempfile.TemporaryDirectory() as tmp:
            csrc = Path(tmp) / "csrc"
            csrc.mkdir()
            (csrc / "groupnorm_silu.cu").write_text(text)
            saved = _build.CSRC, _build.BUILD_DIR
            _build.CSRC, _build.BUILD_DIR = csrc, Path(tmp) / "build"
            gn._library.cache_clear()
            try:
                gn._library()
            finally:
                _build.CSRC, _build.BUILD_DIR = saved
        gen = torch.Generator(device=device).manual_seed(1)
        cases = RESIDENT * (not name.startswith("streaming"))
        cases += STREAMING * (name in ("sound", "streaming_no_merge"))
        for shape, dtype_name in cases:
            x, scale, bias = cs.gn_inputs(shape, dtype_name, gen, device)
            call = lambda x: gn.groupnorm_silu(x, scale, bias, 32, 1e-5)
            cs.emit(dict(variant=name, shape=list(shape), dtype=dtype_name,
                         route=gn.plan(shape, x.dtype, 32, gn._sms(0)).route,
                         kernel_us=kernel_us(lambda: call(x)),
                         ms=cs.cuda_ms(cs.cold_calls(call, x))))
            del x
        gn._library.cache_clear()
    ok = cluster_design(device)
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
