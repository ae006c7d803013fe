#!/usr/bin/env python3
"""The model-axis phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/torch_model_axis_probe.py [PHASE ...]

Builds the kernels, then runs the smoke's model-axis phases with what they
need, each as the smoke runs it: int4_matmul_tp (B6 at a rank's shapes),
model_axis (the full-width 40-layer int4 LLaMA cut into 2 and 4 shard sets
on the card, ``model_axis_schedule`` against the unsharded decode) with
profile_decode (its trace written through ``profile_trace``),
serve_agent_tp (the agent's decode on two gloo ranks sharing the card),
train_mllm (T3, whose losses and checkpoint the FSDP run is held to),
train_mllm_fsdp (T3 under ``trainer.parallel: fsdp``), train_mllm_tp
(stage 3 on a ``(data=1, model=2)`` mesh of two gloo ranks) and qwen_visual
(A8); with phase names, only those (train_mllm_fsdp needs train_mllm).
Each phase runs alone on the card, so its seconds are not shared with
another's. ``train_mllm_tp_rates`` (named only) runs train_mllm_tp at the
SGD rates ``TP_RATES``, each line printed whether its checks hold or not
(``"held"``), to choose the smoke's rate. The last line is ``{"ok": true}``.
"""

from __future__ import annotations

import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

TP_RATES = (1e-3, 1e-4, 3e-5)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_model_axis_probe: no CUDA device", file=sys.stderr)
        return 1
    from diffsensei_tpu_torch.core.config import AgentConfig
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
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
    only = set(sys.argv[1:])
    run = lambda name: not only or name in only
    if run("int4_matmul_tp"):
        smoke.check_int4_tp(device)
    if run("model_axis"):
        llm = ContinuousLVLM.build(AgentConfig(), quantized="int4", device=device, seed=0).llm
        smoke.model_axis(device, llm)
        smoke.profile_decode(device, llm)
        del llm
        torch.cuda.empty_cache()
    for name, phase in (("serve_agent_tp", smoke.serve_agent_tp),
                        ("train_mllm", smoke.train_mllm),
                        ("train_mllm_fsdp", smoke.train_mllm_fsdp),
                        ("train_mllm_tp", smoke.train_mllm_tp),
                        ("qwen_visual", smoke.check_qwen_visual)):
        if run(name):
            phase(device)
            torch.cuda.empty_cache()
    if "train_mllm_tp_rates" in only:
        for lr in TP_RATES:
            try:
                smoke.train_mllm_tp(device, lr)
                held = True
            except AssertionError:
                held = False
            smoke.emit({"phase": "train_mllm_tp_rate", "lr": lr, "held": held})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
