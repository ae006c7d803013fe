#!/usr/bin/env python3
"""The data-axis phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_data_axis_probe.py

Builds the kernels, then runs what those phases need and the phases
themselves, each as the smoke runs it: ring_attention (the ring's schedule
on B1), serve (R1's modules and requests), serve_weights (the artifact
directory the CLIs read), serve_cp (2048² context-parallel against
replicated, then the serve CLI under ``--context-parallel``), train (T1's
six steps, whose losses the next phases are held to), train_dp (DP, FSDP
and an FSDP resume under ``torch.distributed.run``) and train_dp2 (two gloo
ranks on the card). About 7 minutes instead of the smoke's 15; the last line
is ``{"ok": true}``.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_data_axis_probe: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.emit({"phase": "device", "nvidia_smi": smoke.nvidia_smi_line(),
                "torch": torch.__version__})
    with ThreadPoolExecutor(3) as pool:
        for fut in [pool.submit(f) for f in (fa.build, dca.build, gn.build)]:
            fut.result()
    smoke.check_ring(device)
    _, mods, ids, r1 = smoke.serve(device)
    root = pathlib.Path(tempfile.mkdtemp(prefix="diffsensei_weights_"))
    try:
        smoke.serve_weights(device, mods, r1, root)
        smoke.serve_cp(device, mods, ids)
        smoke.serve_cp_cli_check(smoke.serve_cp_cli(root)())
        del mods
        torch.cuda.empty_cache()
        smoke.train(device, root)
        torch.cuda.empty_cache()
        smoke.train_dp(device, root)
        smoke.train_dp2(device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
