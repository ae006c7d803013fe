#!/usr/bin/env python3
"""Build edited copies of the PyTorch port's CUDA kernels beside the sound
ones and hold both to the same checks, on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py

Run from the root of the repository. A variant is one textual edit of a
kernel source, compiled with the port's nvcc flags into a temporary directory
(the checkout is left as it is) and swapped in for the sound library in turn:

* ``flash_pv_kstep`` (a planted fault): B1's P V skips 16 keys of the second
  key tile;
* ``flash_pv_corr`` (a planted fault): B1 skips the rescale of O at the
  second key tile.
  For both, B1's readings (``chip_smoke.flash_readings``) at every row of
  ``chip_smoke.FLASH_CASES``, on the inputs ``chip_smoke.py`` draws, beside
  the sound build's: the limits of ``chip_smoke.flash_agrees`` must pass the
  sound build and refuse each fault at every head_dim-64 row (head_dim 128
  runs another kernel, which the edits do not touch).
* ``flash_tiles``: B1's time at the head_dim-64 rows of
  ``chip_smoke.FLASH_CASES`` with 64-key and with 128-key tiles
  (``FWD_WIDE_KEYS``, the wrapper's threshold, set past every row and then
  below it), alternated three times each.
* ``single_peer_max`` (a planted fault): B8's first block leaves the last
  block of its cluster out of the row max, so its exponentials stand on
  another max than its peers';
* ``chunked_half_corr`` (a planted fault): at chunk 512, B7's second
  warpgroup (a block's second q tile) skips the rescale of its O at the
  second chunk.
  For both, the experiment's readings (``chip_smoke.experiment_readings``)
  at both ``chip_smoke.EXPERIMENT_SHAPES`` beside the sound build's: the
  limits of ``chip_smoke.experiment_agrees`` must pass the sound build and
  refuse each fault at both shapes.
* ``dual_nt16``: B5 keeps 16 key tiles of scores at every key count, where
  the sound build keeps 10 when both key sets fit in 80 keys. B5's time at
  every row of ``chip_smoke.DUAL_CASES``, sound and variant alternated three
  times each, its agreement with the plain twin, each build's occupancy and
  the variant's ptxas lines.

One JSON line each, then the card's ``nvidia-smi`` line, and last
``{"ok": true}`` when every sound reading passes, every fault is refused and
the B5 variant agrees with its twin (else ``{"ok": false}`` and exit code 1).
``--experiments`` runs the B7 and B8 faults alone.
"""

from __future__ import annotations

import contextlib
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the checks and cases of the smoke run)

FAULTS = {
    "flash_pv_kstep": (
        "for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o_acc, pa[kk], desc(sV + 2048 * kk));",
        "for (int kk = 0; kk < BN / 16; ++kk) if (i != 1 || kk != 0) "
        "wgmma_rs(o_acc, pa[kk], desc(sV + 2048 * kk));"),
    "flash_pv_corr": (
        "for (int x = 0; x < 32; ++x) o_acc[x] *= corr[(x & 3) >> 1];",
        "for (int x = 0; x < 32; ++x) o_acc[x] *= i == 1 ? 1.f : corr[(x & 3) >> 1];"),
}
DUAL_NT16 = ("return plan.kt_pad <= 80 && plan.ki_pad <= 80 ? 10 : 16;", "return 16;")
# name: (source, edit); B8 at block_q 512, B7 at chunk 512 (two passes a chunk, two q tiles a block)
EXPERIMENT_FAULTS = {
    "single_peer_max": ("single_pass_attention.cu", (
        "    for (int src = 0; src < 2 * ranks; ++src) {",
        "    for (int src = 0; src < 2 * ranks - (rank == 0 && ranks > 1 ? 2 : 0); ++src) {")),
    "chunked_half_corr": ("chunked_attention.cu", (
        "    if constexpr (SET == SETS / 2) rescale();",
        "    if constexpr (SET == SETS / 2) { if (wg == 0 || c != 1) rescale(); }")),
}


def build_variant(module, source: str, old: str, new: str, tmp: Path):
    """``module``'s ctypes library built from ``source`` with ``old`` replaced
    by ``new`` (once) in a copy under ``tmp``; and that build's ptxas lines."""
    from diffsensei_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    if text.count(old) != 1:
        raise AssertionError(f"{source}: the edit's text occurs {text.count(old)} times")
    csrc = tmp / "csrc"
    csrc.mkdir(parents=True)
    (csrc / source).write_text(text.replace(old, new))
    for header in _build.CSRC.glob("*.cuh"):    # the headers it includes, as they are
        shutil.copy(header, csrc)
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = csrc, tmp / "build"
    try:
        lib = module._library.__wrapped__()
        log = _build.cuda_library(source).with_suffix(".log").read_text()
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    return lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


@contextlib.contextmanager
def swapped(module, lib):
    """Launch ``module``'s kernels from ``lib`` (None: the sound library)."""
    saved = module._library
    if lib is not None:
        module._library = lambda: lib
    try:
        yield
    finally:
        module._library = saved


def flash_faults(device, libs) -> bool:
    import torch
    from diffsensei_tpu_torch.ops import flash_attention as fa

    ok = True
    gen = torch.Generator(device=device).manual_seed(0)
    for case in cs.FLASH_CASES:
        b, h, sq, sk, d, causal, with_bias = case
        q, k, v, bias = cs.flash_inputs(case, gen, device)
        ro, rlse = fa.flash_attention_ref(q.float(), k.float(), v.float(), bias, causal)
        for name, lib in (("sound", None), *libs.items()):
            with swapped(fa, lib):
                o, lse = fa.flash_attention(q, k, v, bias, causal=causal)
                torch.cuda.synchronize()
            r = cs.flash_readings(o, lse, ro, rlse)
            agrees = cs.flash_agrees(r)
            # the limits chip_smoke.py held B1 to before the relative one
            abs_only = (r["max_abs_err_o"] <= cs.FLASH_O_ABS
                        and r["max_abs_err_lse"] <= cs.FLASH_LSE_ABS)
            cs.emit({"phase": "flash_variant", "variant": name, "shape": [b, h, sq, sk, d],
                     "causal": causal, "bias": with_bias, **r, "agrees": agrees,
                     "passes_abs_limits_alone": abs_only})
            ok &= agrees if name == "sound" or d != 64 else not agrees
        del q, k, v, bias, ro, rlse, o, lse
    return ok


def flash_tiles(device) -> None:
    import torch
    from diffsensei_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    sound = fa.FWD_WIDE_KEYS
    try:
        for case in cs.FLASH_CASES:
            b, h, sq, sk, d, causal, with_bias = case
            q, k, v, bias = cs.flash_inputs(case, gen, device)
            if d != 64:
                continue
            call = lambda: fa.flash_attention(q, k, v, bias, causal=causal)
            times = {64: [], 128: []}
            for tile in (64, 128, 128, 64, 64, 128):
                fa.FWD_WIDE_KEYS = 1 << 30 if tile == 64 else 0
                times[tile].append(cs.cuda_ms(call))
            cs.emit({"phase": "flash_tiles", "shape": [b, h, sq, sk, d], "causal": causal,
                     "bias": with_bias, "picked": 128 if sk > sound else 64,
                     "ms_64keys": statistics.median(times[64]),
                     "ms_128keys": statistics.median(times[128]), "times": times})
            del q, k, v, bias
    finally:
        fa.FWD_WIDE_KEYS = sound


def dual_tiles(device, lib, ptxas) -> bool:
    import torch
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca

    ok = True
    cs.emit({"phase": "dual_variant_layout", "variant": "dual_nt16", "ptxas": ptxas})
    gen = torch.Generator(device=device).manual_seed(9)
    for case in cs.DUAL_CASES:
        b, h, sq, d, nt, ni, _ = case
        inputs = cs.dual_inputs(case, gen, device)
        call = lambda: dca.dual_cross_attention(*inputs)
        with swapped(dca, lib):
            got = call()
            torch.cuda.synchronize()
        want = dca.dual_cross_attention_ref(*(t.float() for t in inputs))
        err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
        times = {"sound": [], "dual_nt16": []}
        for name in ("sound", "dual_nt16", "dual_nt16", "sound", "sound", "dual_nt16"):
            with swapped(dca, None if name == "sound" else lib):
                times[name].append(cs.cuda_ms(call))
        occ = {}
        for name in times:
            with swapped(dca, None if name == "sound" else lib):
                occ[name] = dca.occupancy(b, h, sq, nt, ni, d)
        row = dict(shape=[b, h, sq, d], keys=[nt, ni], bias=list(inputs[-1].shape),
                   ms=statistics.median(times["sound"]),
                   ms_nt16=statistics.median(times["dual_nt16"]),
                   times=times, max_abs_err_nt16=err, occupancy=occ)
        cs.emit({"phase": "dual_variant", **row})
        ok &= err <= 2e-2
        del inputs, got, want
    return ok


def experiment_faults(device) -> bool:
    """Each B7 / B8 fault against the sound build at both experiment
    shapes, held to the smoke's limits (against the twin and against B1)."""
    import torch
    from diffsensei_tpu_torch.ops import chunked_attention as ca
    from diffsensei_tpu_torch.ops import flash_attention as fa
    from diffsensei_tpu_torch.ops import single_pass_attention as sp

    ok = True
    tmp = Path(tempfile.mkdtemp(prefix="experiment_variants_"))
    try:
        for name, (source, (old, new)) in EXPERIMENT_FAULTS.items():
            module = sp if source.startswith("single") else ca
            lib, ptxas = build_variant(module, source, old, new, tmp / name)
            call, twin, kw = ((sp.single_pass_attention, sp.single_pass_attention_ref,
                               dict(block_q=512)) if module is sp else
                              (ca.chunked_attention, ca.chunked_attention_ref, dict(chunk=512)))
            gen = torch.Generator(device=device).manual_seed(16)
            for shape in cs.EXPERIMENT_SHAPES:
                qkv = [torch.randn(shape, generator=gen, device=device).bfloat16()
                       for _ in range(3)]
                ref, b1 = twin(*qkv, **kw), fa.flash_attention(*qkv)[0]
                for variant, use in (("sound", None), (name, lib)):
                    with swapped(module, use):
                        o = call(*qkv, **kw)
                        torch.cuda.synchronize()
                    r = cs.experiment_readings(o, ref, b1)
                    agrees = cs.experiment_agrees(r)
                    cs.emit({"phase": "experiment_variant", "variant": variant,
                             "shape": list(shape), **kw, **r, "agrees": agrees})
                    ok &= agrees if variant == "sound" else not agrees
                del qkv, ref, b1, o
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    if sys.argv[1:] == ["--experiments"]:
        ok = experiment_faults(device)
        print(smi, flush=True)
        cs.emit({"ok": bool(ok)})
        return 0 if ok else 1
    fa.build()
    dca.build()
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variants_"))
    try:
        libs = {name: build_variant(fa, "flash_attention.cu", old, new, tmp / name)[0]
                for name, (old, new) in FAULTS.items()}
        nt16, ptxas = build_variant(dca, "dual_cross_attention.cu", *DUAL_NT16,
                                    tmp / "dual_nt16")
        ok = flash_faults(device, libs)
        flash_tiles(device)
        ok &= dual_tiles(device, nt16, ptxas)
        ok &= experiment_faults(device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    cs.emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
