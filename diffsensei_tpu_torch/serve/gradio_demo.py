"""Gradio demos: the full (with the SEED-X agent) and the light (wo-MLLM)
serving UIs (port of ``diffsensei_tpu/serve/gradio_demo.py``).

A prompt box, height and width sliders (128-2048, step 8; the server snaps
them to the bucket grid), samples, seed, character image uploads, character
and dialog bboxes drawn on canvases (normalized to the canvas) or typed one
``x1,y1,x2,y2`` a line, steps, guidance, negative prompt, IP scale, MLLM
scale and the DeepCache interval, all into ``DiffSenseiServer.generate_pil``.

Gradio is optional and absent here: ``build_demo`` imports it and raises a
clear ``ImportError`` without it; the pure helpers need only PIL. The
canvases use ``gradio-image-prompter`` where it is installed, else the
typed boxes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from PIL import Image

from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest


def parse_bbox_text(text: str) -> List[List[float]]:
    """One ``x1,y1,x2,y2`` bbox a line, relative [0, 1] coordinates, corners
    in any order; lines of another count are skipped, blank text gives []."""
    boxes = []
    for line in (text or "").strip().splitlines():
        parts = [p for p in line.replace(",", " ").split() if p]
        if len(parts) != 4:
            continue
        x1, y1, x2, y2 = (float(p) for p in parts)
        boxes.append([min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)])
    return boxes


def normalize_points_to_bboxes(points: Sequence[Sequence[float]],
                               width: int, height: int) -> List[List[float]]:
    """ImagePrompter point sextuples ``[x1, y1, 2, x2, y2, 3]`` -> relative
    bboxes; empty input gives []."""
    boxes = []
    for p in points or []:
        if len(p) >= 6:
            x1, y1, _, x2, y2 = p[0], p[1], p[2], p[3], p[4]
            boxes.append([
                min(x1, x2) / width, min(y1, y2) / height,
                max(x1, x2) / width, max(y1, y2) / height,
            ])
    return boxes


def canvas_to_bboxes(canvas) -> List[List[float]]:
    """A gradio-image-prompter value ``{"image", "points"}`` -> relative
    bboxes, normalized by the canvas image's own size (a PIL image or a
    numpy array ``[H, W, C]``)."""
    if not canvas:
        return []
    img = canvas.get("image")
    points = canvas.get("points") or []
    if img is None or not points:
        return []
    if hasattr(img, "shape"):   # numpy array [H, W, C] (check first: numpy
        height, width = img.shape[:2]  # .size is a scalar, unlike PIL's)
    else:
        width, height = img.size

    return normalize_points_to_bboxes(points, width, height)


def blank_canvas(height: int, width: int):
    """A fresh white drawing canvas of the panel's size."""
    return {"image": Image.new("RGB", (int(width), int(height)), "white"),
            "points": []}


def build_demo(server: DiffSenseiServer, with_mllm: Optional[bool] = None):
    """A ``gr.Blocks`` app over ``server``; ``with_mllm`` defaults to whether
    the server has an agent."""
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover - optional dep
        raise ImportError(
            "gradio is not installed in this environment; use "
            "diffsensei_tpu_torch.serve.api.DiffSenseiServer directly or install "
            "gradio for the UI") from e

    try:
        from gradio_image_prompter import ImagePrompter
        has_prompter = True
    except ImportError:
        ImagePrompter = None
        has_prompter = False

    if with_mllm is None:
        with_mllm = server.agent is not None
    cfg = server.pipeline.config

    def run(prompt, negative, height, width, steps, guidance, num_samples,
            seed, char_files, ip_bbox_text, dialog_bbox_text, ip_scale,
            mllm_scale, deep_cache=1, ip_canvas=None, dialog_canvas=None):
        chars = []
        for f in char_files or []:
            path = getattr(f, "name", f)
            chars.append(Image.open(path).convert("RGB"))
        # drawn boxes win over typed ones
        ip_boxes = canvas_to_bboxes(ip_canvas) or parse_bbox_text(ip_bbox_text)
        dialog_boxes = (canvas_to_bboxes(dialog_canvas)
                        or parse_bbox_text(dialog_bbox_text))
        req = GenerationRequest(
            prompt=prompt, negative_prompt=negative or None,
            height=int(height), width=int(width),
            num_inference_steps=int(steps), guidance_scale=float(guidance),
            num_samples=int(num_samples), seed=int(seed),
            character_images=chars,
            ip_bbox=ip_boxes,
            dialog_bbox=dialog_boxes,
            ip_scale=float(ip_scale),
            mllm_scale=float(mllm_scale) if with_mllm else None,
            deep_cache_interval=(int(deep_cache) if int(deep_cache) > 1
                                 else None),
        )
        return server.generate_pil(req)

    title = "DiffSensei" + ("" if with_mllm else " (wo MLLM)")
    with gr.Blocks(title=title) as demo:
        gr.Markdown(f"# {title}\nCustomized manga panel generation.")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", lines=2)
                negative = gr.Textbox(label="Negative prompt",
                                      value=cfg.negative_prompt, lines=2)
                height = gr.Slider(128, 2048, value=1024, step=8,
                                   label="Height")
                width = gr.Slider(128, 2048, value=1024, step=8,
                                  label="Width")
                steps = gr.Slider(1, 100, value=cfg.num_inference_steps,
                                  step=1, label="Steps")
                guidance = gr.Slider(1.0, 15.0, value=cfg.guidance_scale,
                                     step=0.5, label="Guidance scale")
                num_samples = gr.Slider(1, 4, value=1, step=1,
                                        label="Samples")
                seed = gr.Number(value=0, label="Seed", precision=0)
            with gr.Column():
                char_files = gr.File(label="Character images",
                                     file_count="multiple",
                                     file_types=["image"])
                if has_prompter:
                    ip_canvas = ImagePrompter(
                        label="Draw character boxes (drag a box per char)")
                    dialog_canvas = ImagePrompter(
                        label="Draw dialog boxes")
                    new_canvas = gr.Button("New blank canvases")
                    new_canvas.click(
                        lambda h, w: (blank_canvas(h, w), blank_canvas(h, w)),
                        [height, width], [ip_canvas, dialog_canvas])
                else:
                    ip_canvas = gr.State(None)
                    dialog_canvas = gr.State(None)
                ip_bbox = gr.Textbox(
                    label="Character bboxes (x1,y1,x2,y2 per line, rel.)",
                    lines=4)
                dialog_bbox = gr.Textbox(
                    label="Dialog bboxes (x1,y1,x2,y2 per line, rel.)",
                    lines=4)
                ip_scale = gr.Slider(0.0, 1.0, value=cfg.ip_scale, step=0.05,
                                     label="IP scale")
                mllm_scale = gr.Slider(0.0, 1.0, value=cfg.mllm_scale,
                                       step=0.05, label="MLLM scale",
                                       visible=with_mllm)
                deep_cache = gr.Slider(
                    1, 4, value=1, step=1,
                    label="DeepCache interval (1 = exact, 2-3 = faster)")
        gallery = gr.Gallery(label="Panels")
        gr.Button("Generate", variant="primary").click(
            run,
            [prompt, negative, height, width, steps, guidance, num_samples,
             seed, char_files, ip_bbox, dialog_bbox, ip_scale, mllm_scale,
             deep_cache, ip_canvas, dialog_canvas],
            gallery)
    return demo
