"""Serving cells: a closed loop of one client calling
``DiffSenseiServer.generate`` back to back, requests drawn from the seed by
the cell's traffic file.

A request's index fixes its draws. Requests run in cycles as long as the
longest of the traffic's lists (sizes, character counts, dialog counts):
the k-th request of a cycle takes entry k of each list (modulo its length),
k in an order drawn from the seed, so every seed asks for the same work in
another order.

Correctness: a few requests chosen from the seed (the one with the longest
side first) are followed step by step. Forward hooks keep, for one of their
panels, the UNet's input latents and its noise prediction at every step,
and the latents that enter the VAE decoder. After the window, with the
program freed, the plain reference in fp32 recomputes from the same request:
its own conditioning and the noise prediction at each step on the program's
latents, and checks the program's CFG and Euler step and its start
latents (``step_gap``, the worst of these over the steps); and it decodes
the program's final latents (``image_gap``: the largest pixel
difference).
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import trace as T
from benchmark import weights as W
from benchmark.reference import diffusion as RD
from benchmark.reference import nets as RN



def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([int(k) for k in key])


def _ids(rng, n_words: int, vocab: int):
    """CLIP-L ids (padded with eos) and OpenCLIP-bigG ids (padded with 0) of
    one prompt of ``n_words`` random tokens; the pooled embedding is read
    at the eos."""
    bos, eos = vocab - 2, vocab - 1
    words = rng.integers(1, bos - 1, n_words)
    ids = np.full((1, 77), eos, np.int64)
    ids[0, 0], ids[0, 1:1 + n_words] = bos, words
    ids_2 = ids.copy()
    ids_2[0, 2 + n_words:] = 0
    return ids, ids_2


def _picture(rng, w: int, h: int):
    from PIL import Image

    small = (rng.random((12, 12, 3)) * 255).astype(np.uint8)
    return Image.fromarray(small).resize((int(w), int(h)), Image.BICUBIC)


def _warm_picture(seed: int):
    return _picture(_rng(seed, 5), 200, 300)


def _box(rng, lo: float, hi: float) -> List[float]:
    w, h = rng.uniform(lo, hi, 2)
    x, y = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
    return [float(x), float(y), float(x + w), float(y + h)]


def request_spec(traffic: Dict, seed: int, i: int, vocab: int = 49408) -> Dict:
    """The ``i``-th request of a run: size, character pictures and boxes,
    dialog boxes, token ids, latent seed."""
    lists = [traffic["sizes"], traffic["characters"], traffic["dialogs"]]
    cycle = max(len(v) for v in lists)
    c, p = divmod(i, cycle)
    k = _rng(seed, 1, c).permutation(cycle)[p]    # one order for all lists: fixed pairs
    picks = [v[k % len(v)] for v in lists]
    (h, w), n_chars, n_dialogs = picks
    r = _rng(seed, 2, i)
    lo, hi = traffic["prompt_tokens"]
    prompt, prompt_2 = _ids(r, int(r.integers(lo, hi + 1)), vocab)
    neg = _rng(seed, 3)
    negative, negative_2 = _ids(neg, int(neg.integers(lo, hi + 1)), vocab)
    return dict(
        index=i, height=int(h), width=int(w), num_samples=int(traffic["num_samples"]),
        seed=int(r.integers(0, 2 ** 31 - 1)),
        characters=[_picture(r, *r.integers(96, 400, 2)) for _ in range(n_chars)],
        ip_bbox=[_box(r, 0.15, 0.6) for _ in range(n_chars)],
        dialog_bbox=[_box(r, 0.08, 0.3) for _ in range(n_dialogs)],
        prompt_ids=dict(ids=prompt, neg_ids=negative, ids_2=prompt_2, neg_ids_2=negative_2))


def checked(traffic: Dict, seed: int, vocab: int) -> Dict[int, int]:
    """{request index: panel} followed by the check: the request with the
    longest side among the first ``among_first``, then others drawn from the
    seed."""
    chk = traffic["check"]
    first = list(range(chk["among_first"]))
    specs = {i: request_spec(traffic, seed, i, vocab) for i in first}
    r = _rng(seed, 4)
    order = [first[k] for k in r.permutation(len(first))]
    order.sort(key=lambda i: -max(specs[i]["height"], specs[i]["width"]))
    pick = order[:chk["requests"]]
    return {i: int(r.integers(0, traffic["num_samples"])) for i in pick}


class Capture:
    """Forward hooks that keep, during a checked request, one panel's UNet
    inputs and outputs at every step and its decoder inputs."""

    def __init__(self, mods):
        self.panel = None
        self.n = 1
        self.steps: List = []
        self.tiles: List = []
        self.handles = [
            mods.unet.register_forward_hook(self._unet, with_kwargs=True),
            mods.vae.post_quant_conv.register_forward_pre_hook(self._decode)]

    def _unet(self, mod, args, kwargs, out):
        if self.panel is not None:
            j, n = self.panel, self.n
            self.steps.append((args[0][j].detach().clone(),
                               out[[j, n + j]].detach().clone()))

    def _decode(self, mod, args):
        if self.panel is not None:
            self.tiles.append(args[0][self.panel].detach().clone())

    def take(self):
        got = (self.steps, self.tiles)
        self.steps, self.tiles = [], []
        return got

    def remove(self):
        for h in self.handles:
            h.remove()


def run(ctx) -> Dict:
    from benchmark import program as P

    cfg, traffic, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    stack = cfg["stack"]
    vocab = stack["text_encoder"]["vocab_size"]
    weights = W.make(stack, seed, dev)
    mods = P.modules(stack, weights, dev)
    del weights
    if ctx.variant == "control":        # the program's int8 UNet, and TF32 for the VAE
        P.int8_unet(mods)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    server = P.server(cfg, mods, traffic["auto_batch_max_side"])
    make = P.request

    # warm-up: one short request a (size, with and without characters)
    base = request_spec(traffic, seed, 0, vocab)
    for h, w in traffic["sizes"]:
        for n_chars in sorted({min(n, 1) for n in traffic["characters"]}):
            server.generate(make(dict(base, height=h, width=w, steps=traffic["warmup_steps"],
                                      characters=[_warm_picture(seed)] * n_chars,
                                      ip_bbox=[[0.1, 0.1, 0.6, 0.7]] * n_chars)))
    T.sync(dev)

    want = checked(traffic, seed, vocab)
    cap = Capture(mods)
    latencies, failed, captured, images = [], 0, {}, {}
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        spec = request_spec(traffic, seed, i, vocab)
        cap.panel, cap.n = want.get(i), spec["num_samples"]
        ts = time.perf_counter()
        try:
            out = server.generate(make(spec))
        except RuntimeError as e:       # a failed request counts, the loop goes on
            ctx.log(f"request {i} failed: {e}")
            failed += 1
            out = None
        latencies.append(time.perf_counter() - ts)
        if i in want:
            captured[i] = cap.take()
            if out is not None:
                images[i] = out[want[i]]
        cap.panel = None
        i += 1
    t_end = time.perf_counter()
    for j in [k for k in want if k not in captured]:     # due in the window: wait for it
        spec = request_spec(traffic, seed, j, vocab)
        cap.panel, cap.n = want[j], spec["num_samples"]
        images[j] = server.generate(make(spec))[want[j]]
        captured[j] = cap.take()
        cap.panel = None
    cap.remove()
    span = t_end - t0
    panels = (i - failed) * traffic["num_samples"]
    e2e = {"panels_per_s": (panels / span, "panels/s"),
           "request_s_p90": (statistics.quantiles(latencies, n=10)[-1] if len(latencies) > 1
                             else latencies[0], "s"),
           "setup_s": (ctx.setup_s, "s")}
    layer = None
    if ctx.trace:
        layer = _traced(ctx, server, mods, traffic, seed, i, vocab)
        layer["latencies"] = latencies
        layer["span"] = span
    peak = T.peak_bytes(dev)
    specs = {k: request_spec(traffic, seed, k, vocab) for k in want}
    del server, mods, cap
    T.free_memory()
    check = reference_check(cfg, ctx, specs, want, captured, images)
    return dict(attempted=i, failed=failed, e2e=e2e, layer=layer, peak=peak, check=check)


def _traced(ctx, server, mods, traffic, seed, start, vocab) -> Dict:
    """After the window: ``trace_requests`` more requests under the
    profiler, with spans around the layers and the kernels' launch shapes."""
    from benchmark import program as P
    from diffsensei_tpu_torch.pipelines import pipeline as pipe_mod

    spans = T.Spans()
    pipe = server.pipeline
    undo = [spans.wrap(pipe, "encode_prompt", "conditioning"),
            spans.wrap(pipe, "prepare_ip_image_embeds", "conditioning"),
            spans.wrap(pipe_mod, "_decode", "decode")]
    pre = mods.unet.register_forward_pre_hook(lambda m, a: spans.open())
    post = mods.unet.register_forward_hook(lambda m, a, o: spans.close("unet"))
    specs = [request_spec(traffic, seed, start + k, vocab)
             for k in range(traffic["trace_requests"])]
    with T.Launches() as launches, T.DeviceTrace() as dt:
        for spec in specs:
            server.generate(P.request(spec))
    pre.remove()
    post.remove()
    for u in undo:
        u()
    T.sync(ctx.device)
    return dict(spans={k: spans.ms(k) for k in spans.events}, launches=launches.shapes,
                trace=dt, requests=len(specs))


def reference_check(cfg, ctx, specs, want, captured, images) -> Dict:
    """``step_gap`` and ``image_gap`` of the checked panels against the plain
    reference in fp32 (TF32 off). A step's gap is the largest of: the
    relative distance of the program's noise prediction (both CFG rows) to
    the reference's on the same input latents; that of its next latents to
    CFG and the Euler step applied to its own prediction, over the step's
    length; and at step 0 that of its start latents to the reference's own
    draw from the request's seed. ``image_gap`` is the largest pixel
    difference of the panel against the reference's decode of the latents
    that entered the program's decoder."""
    dev = ctx.device
    stack = cfg["stack"]
    s = cfg["sampler"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        nets = RN.build(stack)
    ref = W.make(stack, ctx.seed, dev, upcast=True)
    for name, net in nets.items():
        net.load_state_dict(ref[name], strict=True, assign=True)
        net.eval().requires_grad_(False)
    del ref
    t_tab, sig, init = (x.to(dev) for x in RD.euler_tables(s["num_inference_steps"]))
    norm = torch.linalg.vector_norm
    parts = dict(start=0.0, eps=0.0, sampler=0.0)
    image_gap = 0.0
    fp8 = None
    if ctx.variant == "fp8_reference":     # a control: the reference's UNet in fp8
        from benchmark.reference.fp8 import fp8_copy

        fp8, fp8_gap = dict(nets, unet=fp8_copy(nets["unet"])), 0.0
    with torch.no_grad():
        for i, panel in want.items():
            spec, (steps, tiles) = specs[i], captured[i]
            if len(steps) != s["num_inference_steps"] or i not in images:
                return dict(step_gap=math.inf, image_gap=math.inf, **parts)
            cond = RD.panel_conditioning(nets, stack, spec, dev)
            f = nets["vae"].factor
            lh, lw = spec["height"] // f, spec["width"] // f
            gen = torch.Generator().manual_seed(spec["seed"])
            start = torch.randn((spec["num_samples"], lh, lw, stack["unet"]["in_channels"]),
                                generator=gen)[panel].to(dev) * init
            z = torch.zeros((lh, lw, stack["vae"]["latent_channels"]), device=dev)
            for (y0, x0), tile in zip(RN.tile_plan(lh, lw) if max(lh, lw) > 128 else [(0, 0)], tiles):
                z[y0:y0 + tile.shape[0], x0:x0 + tile.shape[1]] = tile.float()
            final = z * stack["vae"]["scaling_factor"]
            lats = [st[0].float() * torch.sqrt(sig[k] ** 2 + 1) for k, st in enumerate(steps)] + [final]
            parts["start"] = max(parts["start"], (norm(lats[0] - start) / norm(start)).item())
            for k, (lat_in, eps) in enumerate(steps):
                eps = eps.float()
                want_eps = RD.unet_rows(nets, cond, torch.stack([lat_in.float()] * 2), t_tab[k],
                                        s["ip_scale"])
                parts["eps"] = max(parts["eps"], (norm(eps - want_eps) / norm(want_eps)).item())
                if fp8 is not None:
                    low = RD.unet_rows(fp8, cond, torch.stack([lat_in.float()] * 2), t_tab[k],
                                       s["ip_scale"])
                    fp8_gap = max(fp8_gap, (norm(low - want_eps) / norm(want_eps)).item())
                guided = eps[0] + s["guidance_scale"] * (eps[1] - eps[0])
                want_next = RD.euler_step(lats[k], guided, sig[k], sig[k + 1])
                parts["sampler"] = max(parts["sampler"], (
                    norm(lats[k + 1] - want_next) / norm(want_next - lats[k])).item())
            img = RN.decode_image(nets["vae"], final[None], stack["vae"]["scaling_factor"])[0]
            image_gap = max(image_gap, (img - torch.from_numpy(images[i]).to(dev)).abs().max().item())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ctx.log(f"step_gap parts: {parts}")
    out = dict(step_gap=max(parts.values()), image_gap=image_gap, **parts)
    if fp8 is not None:
        out["fp8_eps"] = fp8_gap
    return out
