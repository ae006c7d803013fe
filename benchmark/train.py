"""Training cells: the stage-2 step that ``train/cli.py`` builds, driven over
the prefetch loader's stream as ``train/runner.py`` drives it (one device
generator seeded from the run's seed, one ``step_fn`` call a batch), without
its logs and checkpoints: nothing is written but the page set.

The page set is MangaZero's schema (``chip_smoke.write_mangazero``'s,
copied): pages drawn from the seed into a temporary directory, one frame a
page in the 1024x1024 bucket, so every batch is the bucket's.

Set-up builds the step and drives its first ``checked_steps`` steps through
the same call and stream; the window continues on that object. Those steps
are compared with the plain reference (fp32, TF32 off) after the window:
each step's loss (``loss_gap``), the first gradient as AdamW got it, from
its first moment after one update (``grad_gap``, worst leaf), and the
trainables' change over the steps (``change_gap``, worst leaf, leaving out
leaves whose reference gradient is under a thousandth of the median
leaf's). A leaf's gap is the gap of the two norms over the larger of the
reference's norm of that leaf and of the median leaf. The traffic file's
``limits`` name the numbers that decide ``correct``.
"""

from __future__ import annotations

import json
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from benchmark import trace as T
from benchmark import weights as W
from benchmark.reference import data as RDATA
from benchmark.reference import diffusion as RD
from benchmark.reference import nets as RN

WORDS = ["girl", "boy", "rain", "street", "umbrella", "talks", "shouts", "night", "room"]


def write_pages(root: Path, t: Dict, seed: int) -> None:
    """MangaZero pages: each one frame of ``frame_size`` (the 1024² bucket)
    on a page of ``page_size``, with ``characters`` characters and
    ``dialogs`` dialog boxes, the page a smooth random PNG."""
    from PIL import Image

    rng = np.random.default_rng([int(seed), 7])
    size, frame = t["page_size"], t["frame_size"]
    x0 = y0 = (size - frame) // 2

    def box(w_range, h_range):     # sides as shares of the frame
        w = rng.integers(int(w_range[0] * frame), int(w_range[1] * frame))
        h = rng.integers(int(h_range[0] * frame), int(h_range[1] * frame))
        x, y = rng.integers(x0, x0 + frame - w), rng.integers(y0, y0 + frame - h)
        return [int(x), int(y), int(x + w), int(y + h)]

    anns, pictures = [], []
    for p in range(t["pages"]):
        pictures.append((rng.random((36, 36, 3)) * 255).astype(np.uint8))
        anns.append({"image_path": f"page_{p}.png", "frames": [{
            "bbox": [x0, y0, x0 + frame, y0 + frame],
            "caption": " ".join(rng.choice(WORDS, t["caption_words"])),
            "characters": [{"id": c, "bbox": box((0.146, 0.39), (0.195, 0.586)), "type": 0}
                           for c in range(t["characters"])],
            "dialogs": [{"bbox": box((0.098, 0.293), (0.059, 0.195))} for _ in range(t["dialogs"])]}]})

    def save(p):
        Image.fromarray(pictures[p]).resize((size, size), Image.BICUBIC).save(root / f"page_{p}.png")

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(save, range(t["pages"])))
    (root / "annotations.json").write_text(json.dumps(anns))


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves=None) -> float:
    keys = list(want) if leaves is None else leaves
    median = statistics.median(want[k] for k in want)
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in keys)


def run(ctx) -> Dict:
    from benchmark import program as P
    import torch.distributed as dist

    cfg, traffic, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    if ctx.variant == "control":
        cfg = dict(cfg, param_dtype="bfloat16")
    stack = cfg["stack"]
    tmp = tempfile.TemporaryDirectory(prefix="stage2-pages-")
    root = Path(tmp.name)
    write_pages(root, traffic, seed)
    weights = W.make(stack, seed, dev)
    mods = P.modules(stack, weights, dev)
    del weights
    step_fn, state, frozen, batches_from, env = P.trainer(
        cfg, mods, str(root / "annotations.json"), str(root), seed, traffic["num_workers"], dev)
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    stream = batches_from(0)
    batches = iter(stream)

    def next_batch():
        batch = next(batches)
        if ctx.fault == "half_batch":        # a planted fault: the mean over half the rows
            half = batch["pixel_values"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        return batch

    # set-up: the checked steps, through the window's own call and stream
    start = {k: p.detach().clone() for k, p in state.params.items()}
    losses, first_grad = [], {}
    beta1 = cfg["optimizer"]["betas"][0]
    for s in range(traffic["checked_steps"]):
        metrics = step_fn(state, frozen, next_batch(), generator)
        losses.append(float(metrics["loss"]))
        if s == 0:
            # a parameter the optimizer never took has no moment: no gradient reached it
            opt_state = state.optimizer.adamw.state
            first_grad = {k: (torch.linalg.vector_norm(opt_state[p]["exp_avg"].float())
                              / (1 - beta1)).item() if p in opt_state else 0.0
                          for k, p in state.params.items()}
    change = {k: torch.linalg.vector_norm(p.detach().float() - start[k].float()).item()
              for k, p in state.params.items()}
    del start
    T.sync(dev)

    waits, steps = [], 0
    batch_rows = None
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start
    while True:
        tw = time.perf_counter()
        batch = next_batch()
        waits.append(time.perf_counter() - tw)
        batch_rows = batch["pixel_values"].shape[0]
        step_fn(state, frozen, batch, generator)
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    T.sync(dev)
    span = time.perf_counter() - t0
    e2e = {"train_samples_per_s": (steps * batch_rows / span, "samples/s"),
           "setup_s": (ctx.setup_s, "s")}
    layer = None
    if ctx.trace:
        spans = T.Spans()
        undo = spans.wrap(mods.vae, "encode", "vae_encode")
        with T.Launches() as launches, T.DeviceTrace() as dt:
            for _ in range(traffic["trace_steps"]):
                step_fn(state, frozen, next_batch(), generator)
        undo()
        T.sync(dev)
        layer = dict(spans={k: spans.ms(k) for k in spans.events}, launches=launches.shapes,
                     trace=dt, steps=traffic["trace_steps"], waits=waits, span=span,
                     window_steps=steps, batch_rows=batch_rows)
    peak = T.peak_bytes(dev)
    if hasattr(batches, "close"):
        batches.close()
    del batches, stream, step_fn, state, frozen, mods
    T.free_memory()
    if dist.is_initialized():
        dist.destroy_process_group()
    check = reference_check(cfg, ctx, root, losses, first_grad, change)
    tmp.cleanup()
    return dict(attempted=steps, failed=0, e2e=e2e, layer=layer, peak=peak, check=check)


def reference_check(cfg, ctx, root: Path, losses, first_grad, change) -> Dict:
    dev = ctx.device
    stack = cfg["stack"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        nets = RN.build(stack)
    ref = W.make(stack, ctx.seed, dev, upcast=True)
    for name, net in nets.items():
        net.load_state_dict(ref[name], strict=True, assign=True)
        net.eval().requires_grad_(False)
    del ref
    nets["unet"].checkpointed = bool(cfg.get("remat"))
    names = RD.trainable_names(nets, cfg["unet_trained_parameters"])
    params = {}
    for full in names:
        net, name = full.split(".", 1)
        p = nets[net].get_parameter(name)
        p.requires_grad_(True)
        params[full] = p
    opt = RD.AdamW(params, cfg["optimizer"])
    pages = RDATA.Pages(str(root / "annotations.json"), str(root), cfg["train_data"], stack["manga"],
                        stack["text_encoder"]["vocab_size"], stack["text_encoder_2"]["vocab_size"])
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed))
    start = {k: p.detach().clone() for k, p in params.items()}
    ref_losses, ref_grad = [], {}
    epoch = pages.epoch(int(ctx.seed))
    for s in range(len(losses)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(epoch).items()}
        loss, grads = RD.stage2_loss_and_grads(nets, stack, batch, gen,
                                               cfg["ip_contrastive_loss_weight"], params)
        grads = opt.clipped(grads)
        if s == 0:
            ref_grad = {k: torch.linalg.vector_norm(g).item() for k, g in grads.items()}
        opt.step(grads, RD.lr_at(s, cfg["optimizer"], cfg["lr_scheduler"], cfg["max_train_steps"]))
        ref_losses.append(loss)
    ref_change = {k: torch.linalg.vector_norm(p.detach() - start[k]).item()
                  for k, p in params.items()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    median = statistics.median(ref_grad.values())
    moving = [k for k in ref_grad if ref_grad[k] >= 1e-3 * median]
    return dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        grad_gap=_leaf_gaps(first_grad, ref_grad),
        change_gap=_leaf_gaps(change, ref_change, moving))
