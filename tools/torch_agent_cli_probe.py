#!/usr/bin/env python3
"""The agent_cli phase of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_agent_cli_probe.py

Builds the kernels, then runs what the phase needs and the phase itself,
each as the smoke runs it: serve (R1's modules and requests), serve_weights
(the artifact directory and CLIP vocabulary the serve CLI reads),
agent_weights (the 2-layer SEED-X-width agent checkpoint) and agent_cli
(the serve CLI's agent panel from files, ``--mllm-tokenizer`` among them).
About 140 s on one H100 instead of the smoke's 17 minutes; the last line is
``{"ok": true}``.
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
        print("torch_agent_cli_probe: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.ops import dual_cross_attention as dca
    from diffsensei_tpu_torch.ops import flash_attention as fa, groupnorm as gn
    from diffsensei_tpu_torch.ops import int4_matmul as i4

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.emit({"phase": "device", "nvidia_smi": smoke.nvidia_smi_line(),
                "torch": torch.__version__})
    with ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(f) for f in (fa.build, dca.build, gn.build, i4.build)]:
            fut.result()
    _, mods, _, r1 = smoke.serve(device)
    root = pathlib.Path(tempfile.mkdtemp(prefix="diffsensei_weights_"))
    try:
        smoke.serve_weights(device, mods, r1, root)
        smoke.agent_weights(device, root)
        smoke.agent_cli(device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
