"""Checkpoint files -> the port's modules (port of
``diffsensei_tpu/utils/load.py`` and of the name rules in
``diffsensei_tpu/utils/port_torch.py``).

The port's modules carry the reference's names (diffusers for the UNet and
the VAE, HF for the CLIP and ViTMAE encoders, the reference's for the
Resampler and the agent's resamplers), so a checkpoint mostly loads by name.
The rules here are the JAX porters' where names or contents differ:

* the UNet's IP projections live under ``attn2.processor.to_{k,v}_ip``;
  merged ``attn2.to_{k,v}_ip`` names load too. A plain-SDXL UNet without
  them gets copies of its blocks' ``to_k``/``to_v`` (the reference's init),
  and a missing ``dialog_bbox_embedding`` is zeros;
* the Resampler's ``latents`` / ``dummy_tokens`` take the module's shape, and
  ``module.`` prefixes are stripped; the same holds where ``modules.resampler``
  is a linear projection (``models/projection.py``), whose reference names
  are the JAX ``port_image_proj``'s: ``proj.*``, ``norm.*`` and, for
  ``ImageProjDummyModel``, ``proj_magi.*`` and ``dummy_tokens``;
* HF and peft LLaMA names map onto the port's (``layers.{i}.attn.q_proj.base``
  ...); the Qwen resamplers' fixed ``pos_embed`` is recomputed, not loaded.

As strict as the JAX porters: a key they read that the file lacks raises, a
key they never read (HF's ``position_ids``, ``visual_projection``, a ViTMAE
checkpoint's ``decoder.*`` ...) is ignored and listed on stdout. Adapter
(LoRA) weights a file lacks load as zeros, as the JAX trees lack them.

Every tensor is cast to its module parameter's dtype and laid out with its
strides (``channels_last`` where ``PipelineModules.sdxl`` set it) on the
module's device before ``load_state_dict(..., assign=True)``; the modules end
in ``eval()`` with no gradients. Files: ``.safetensors`` through the reader below (no
``safetensors`` package), anything else through ``torch.load``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

KNOWN_WEIGHTS = ("unet", "vae", "text_encoder", "text_encoder_2", "image_encoder",
                 "magi_encoder", "resampler", "image_proj", "diffsensei_ckpt", "ip_adapter",
                 "ckpt_path")

# released-artifact subpaths under <ckpt_path>/image_generator (the reference
# demo's layout plus the diffusers / HF file names), first found wins
ARTIFACT_FILES = {
    "unet": ("unet/pytorch_model.bin", "unet/diffusion_pytorch_model.safetensors"),
    "resampler": ("image_proj_model/pytorch_model.bin",),
    "vae": ("vae/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.bin"),
    "text_encoder": ("text_encoder/model.safetensors", "text_encoder/pytorch_model.bin"),
    "text_encoder_2": ("text_encoder_2/model.safetensors", "text_encoder_2/pytorch_model.bin"),
    "image_encoder": ("clip_image_encoder/model.safetensors",
                      "clip_image_encoder/pytorch_model.bin"),
    "magi_encoder": ("magi_image_encoder/model.safetensors",
                     "magi_image_encoder/pytorch_model.bin"),
}


# ---------------------------------------------------------------------------
# reading files
# ---------------------------------------------------------------------------
# safetensors dtype -> (numpy dtype of the bytes, torch dtype to view them as)
_ST_DTYPES = {"F32": (np.float32, None), "F16": (np.float16, None),
              "BF16": (np.int16, torch.bfloat16), "I8": (np.int8, None),
              "U8": (np.uint8, None), "I64": (np.int64, None)}


def read_safetensors(path: str) -> StateDict:
    """A ``.safetensors`` file as CPU tensors over a copy-on-write memory map:
    an 8-byte little-endian header length, the JSON header, then the raw
    little-endian bytes at each entry's ``data_offsets``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    body = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n) if header else None
    out: StateDict = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        np_dtype, view = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        raw = body[start:end]
        if start % np.dtype(np_dtype).itemsize:
            raw = raw.copy()                         # an unaligned entry
        t = torch.from_numpy(raw.view(np_dtype).reshape(info["shape"]))
        out[name] = t.view(view) if view is not None else t
    return out


def load_torch_file(path: str) -> Dict[str, Any]:
    """A checkpoint file as a (possibly nested) dict of CPU tensors:
    ``.safetensors`` through :func:`read_safetensors`, others through
    ``torch.load`` (weights only, memory-mapped)."""
    path = os.fspath(path)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def split_prefixed(sd: Mapping[str, Any], groups: Iterable[str]) -> Dict[str, Dict[str, Any]]:
    """A flat dict with ``<group>.`` prefixes (an IP-Adapter safetensors
    file's ``image_proj.`` / ``ip_adapter.``) -> ``{group: {rest: value}}``."""
    out: Dict[str, Dict[str, Any]] = {g: {} for g in groups}
    for key, value in sd.items():
        for g in out:
            if key.startswith(g + "."):
                out[g][key[len(g) + 1:]] = value
    return out


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the DDP ``module.`` prefix where a key has it."""
    return {k.removeprefix("module."): v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# putting tensors into modules
# ---------------------------------------------------------------------------
def _report_ignored(component: str, keys: Iterable[str]) -> None:
    keys = sorted(keys)
    if keys:
        more = f" ... (+{len(keys) - 4})" if len(keys) > 4 else ""
        print(f"# {component}: ignored {len(keys)} key(s) the module does not read: "
              f"{', '.join(keys[:4])}{more}")


def _target_device(module: nn.Module, device) -> torch.device:
    for p in module.parameters():
        if not p.is_meta:
            return p.device
    if device is None:
        raise ValueError("the module is on the meta device: pass the device to load onto")
    return torch.device(device)


def assign(module: nn.Module, entries: Mapping[str, torch.Tensor], device=None,
           component: str = "module", reshape: Iterable[str] = ()) -> None:
    """Put ``entries`` (port names; every parameter, or a subset of a module
    already on a device) into ``module``: each tensor cast to its parameter's
    dtype and laid out with its strides on the module's device (``device``
    for a module still on meta), then ``load_state_dict(..., assign=True)``.
    Names in ``reshape`` may differ in shape but not in size."""
    current = module.state_dict(keep_vars=True)
    dev = _target_device(module, device)
    new = {}
    for name, value in entries.items():
        old = current[name]
        if tuple(value.shape) != tuple(old.shape):
            if name not in reshape or value.numel() != old.numel():
                raise ValueError(f"{component}: {name} is {tuple(value.shape)} in the file, "
                                 f"{tuple(old.shape)} in the module")
            value = value.reshape(old.shape)
        out = torch.empty_strided(old.shape, old.stride(), dtype=old.dtype, device=dev)
        new[name] = out.copy_(value.to(old.dtype))
    module.load_state_dict(new, strict=len(new) == len(current), assign=True)
    module.eval().requires_grad_(False)


def take(module: nn.Module, sd: Mapping[str, torch.Tensor], component: str,
         optional: Iterable[str] = (), rename=None) -> StateDict:
    """The module's entries out of ``sd`` by name (``rename(file_key)`` maps
    a file's names to the port's first); the names the module does not hold
    are listed and ignored, a parameter the file lacks raises unless it is
    ``optional``."""
    if rename is not None:
        sd = {rename(k): v for k, v in sd.items()}
    names, optional = module.state_dict().keys(), set(optional)
    _report_ignored(component, set(sd) - set(names))
    missing = [n for n in names if n not in sd and n not in optional]
    if missing:
        more = f" ... (+{len(missing) - 6})" if len(missing) > 6 else ""
        raise KeyError(f"{component}: the checkpoint lacks {len(missing)} key(s) the module "
                       f"needs: {', '.join(missing[:6])}{more}")
    return {n: sd[n] for n in names if n in sd}


def _adapters(names: Iterable[str]) -> List[str]:
    return [n for n in names if ".lora_A." in n or ".lora_B." in n]


def _zeros_for(module: nn.Module, names: Iterable[str]) -> StateDict:
    shapes = {n: p.shape for n, p in module.state_dict(keep_vars=True).items()}
    return {n: torch.zeros(shapes[n]) for n in names}


# ---------------------------------------------------------------------------
# the name rules, per component
# ---------------------------------------------------------------------------
def _ip_name(key: str) -> str:
    """Merged ``attn2.to_{k,v}_ip`` -> the port's ``attn2.processor.to_{k,v}_ip``."""
    for which in ("to_k_ip", "to_v_ip"):
        key = key.replace(f".attn2.{which}.", f".attn2.processor.{which}.")
    return key


def unet_entries(unet: nn.Module, sd: Mapping[str, torch.Tensor]) -> Tuple[StateDict, int]:
    """A full diffusers / DiffSensei UNet state dict -> every parameter of
    ``unet``; returns ``(entries, IP blocks seeded)``. IP projections the
    file lacks are copies of the block's ``to_k``/``to_v`` (a plain-SDXL
    checkpoint), a missing ``dialog_bbox_embedding`` is zeros, missing
    adapters are zeros."""
    names = list(unet.state_dict().keys())
    ip = [n for n in names if ".processor.to_k_ip." in n or ".processor.to_v_ip." in n]
    dialog = [n for n in names if n == "dialog_bbox_embedding"]
    entries = take(unet, sd, "unet", optional=ip + dialog + _adapters(names), rename=_ip_name)
    seeded = 0
    for k_ip in (n for n in ip if ".to_k_ip." in n):
        v_ip = k_ip.replace(".to_k_ip.", ".to_v_ip.")
        if (k_ip in entries) != (v_ip in entries):
            raise KeyError(f"unet: the checkpoint has one of {k_ip} and {v_ip} only")
        if k_ip not in entries:
            seeded += 1
            for n, proj in ((k_ip, ".to_k."), (v_ip, ".to_v.")):
                entries[n] = entries[n.replace(".processor.to_k_ip.", proj)
                                     .replace(".processor.to_v_ip.", proj)].clone()
    entries.update(_zeros_for(unet, [n for n in dialog + _adapters(names) if n not in entries]))
    return entries, seeded


def unet_overlay_entries(unet: nn.Module, sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A partial stage-2 dict (``unet_trained`` without ``conv_in``): only
    its IP projections and dialog embedding, by name, as the JAX
    ``port_sdxl_unet_partial`` reads them; anything else is ignored."""
    names = set(unet.state_dict().keys())
    out, ignored = {}, []
    for key, value in sd.items():
        key = _ip_name(key)
        if key == "dialog_bbox_embedding" or key.endswith(("to_k_ip.weight", "to_v_ip.weight")):
            if key not in names:
                raise KeyError(f"unet_trained: {key} names no parameter of the UNet")
            out[key] = value
        else:
            ignored.append(key)
    _report_ignored("unet_trained", ignored)
    return out


def resampler_entries(resampler: nn.Module, sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The entries of a ``Resampler`` or of an ``ImageProj{,Dummy}Model``
    (``proj``, ``norm``, ``proj_magi``, ``dummy_tokens``) by their reference
    names, ``module.`` prefixes stripped."""
    return take(resampler, strip_module_prefix(sd), "resampler")


_LLAMA_NAMES = (("self_attn.", "attn."), ("input_layernorm.", "input_norm."),
                ("post_attention_layernorm.", "post_norm."))
_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def llama_name(key: str) -> str:
    """An HF (optionally peft-wrapped) LLaMA name -> the port's."""
    key = key.replace("base_model.model.", "").replace(".base_layer.", ".")
    key = key.replace(".lora_A.default.", ".lora_A.").replace(".lora_B.default.", ".lora_B.")
    key = key.removeprefix("model.")
    for hf, ours in _LLAMA_NAMES:
        key = key.replace(hf, ours)
    for proj in _PROJECTIONS:
        key = key.replace(f".{proj}.weight", f".{proj}.base.weight")
    return key


def llama_entries(llm: nn.Module, sd: Mapping[str, torch.Tensor]) -> StateDict:
    names = list(llm.state_dict().keys())
    entries = take(llm, sd, "llm", optional=_adapters(names), rename=llama_name)
    entries.update(_zeros_for(llm, [n for n in _adapters(names) if n not in entries]))
    return entries


def attn_processor_slots(cfg) -> List[Optional[str]]:
    """The UNet's attention processors in the order of the reference's
    ``nn.ModuleList(unet.attn_processors.values())`` (an IP-Adapter file's
    ``{i}.to_k_ip.weight`` indices): down blocks, then up, then mid; in each
    transformer block the parameterless attn1 processor (``None``) before
    attn2 (its ``...attn2.processor`` name). The JAX
    ``port_torch.attn_processor_slots``."""
    slots: List[Optional[str]] = []
    tl = cfg.transformer_layers_per_block
    n = len(cfg.block_out_channels)

    def add(base: str, blocks: int) -> None:
        for k in range(blocks):
            slots.extend((None, f"{base}.transformer_blocks.{k}.attn2.processor"))

    for level in range(n):
        for j in range(cfg.layers_per_block if tl[level] else 0):
            add(f"down_blocks.{level}.attentions.{j}", tl[level])
    for rev, level in enumerate(reversed(range(n))):
        for j in range(cfg.layers_per_block + 1 if tl[level] else 0):
            add(f"up_blocks.{rev}.attentions.{j}", tl[level])
    add("mid_block.attentions.0", cfg.mid_transformer_layers)
    return slots


def ip_adapter_entries(cfg, ip_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """An ``ip_adapter`` group (``{i}.to_{k,v}_ip.weight`` by processor
    index) -> the UNet's IP projections; a weight that matches no attn2 slot
    raises (it would land on the wrong layer)."""
    out, consumed = {}, set()
    for idx, name in enumerate(attn_processor_slots(cfg)):
        kw, vw = f"{idx}.to_k_ip.weight", f"{idx}.to_v_ip.weight"
        if name is None or kw not in ip_sd:
            continue
        out[f"{name}.to_k_ip.weight"] = ip_sd[kw]
        out[f"{name}.to_v_ip.weight"] = ip_sd[vw]
        consumed.update((kw, vw))
    leftover = [k for k in ip_sd if k.endswith((".to_k_ip.weight", ".to_v_ip.weight"))
                and k not in consumed]
    if leftover:
        raise ValueError(f"ip_adapter keys matched no attn2 processor slot: {leftover[:6]}"
                         f"{'...' if len(leftover) > 6 else ''}: index layout mismatch")
    return out


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def _resolve_artifact(weights_cfg: Dict[str, Any]) -> Dict[str, Any]:
    gen = os.path.join(weights_cfg["ckpt_path"], "image_generator")
    cfg = {k: v for k, v in weights_cfg.items() if k != "ckpt_path"}
    for name, candidates in ARTIFACT_FILES.items():
        for rel in candidates:
            path = os.path.join(gen, *rel.split("/"))
            if os.path.exists(path):
                cfg.setdefault(name, path)
                break
    return cfg


def apply_ported_weights(modules, weights_cfg: Mapping[str, Any], device=None):
    """Load the checkpoint files of ``weights_cfg`` (component -> path) into
    ``modules`` (a ``PipelineModules``) and return it. Components: ``unet``,
    ``vae``, ``text_encoder``, ``text_encoder_2``, ``image_encoder``,
    ``magi_encoder``, ``resampler`` / ``image_proj`` (single state dicts);
    ``diffsensei_ckpt`` (a stage-2 ``{"image_proj", "unet_trained"}`` dict);
    ``ip_adapter`` (``{"image_proj", "ip_adapter"}``, a torch dict or flat
    safetensors); ``ckpt_path`` (a released artifact directory). An unknown
    key raises. Modules on meta load onto ``device`` (default the modules'
    own)."""
    unknown = set(weights_cfg) - set(KNOWN_WEIGHTS)
    if unknown:
        raise ValueError(f"unknown weights keys {sorted(unknown)}; expected from "
                         f"{sorted(KNOWN_WEIGHTS)}")
    cfg = dict(weights_cfg)
    if "ckpt_path" in cfg:
        cfg = _resolve_artifact(cfg)
    device = device if device is not None else modules.device

    if "unet" in cfg:
        entries, seeded = unet_entries(modules.unet, load_torch_file(cfg["unet"]))
        assign(modules.unet, entries, device, "unet")
        if seeded:
            print(f"# unet: {seeded} IP projections seeded from frozen to_k/to_v "
                  "(plain-SDXL checkpoint)")
    for name in ("vae", "text_encoder", "text_encoder_2", "image_encoder", "magi_encoder"):
        if name in cfg:
            mod = getattr(modules, name)
            assign(mod, take(mod, load_torch_file(cfg[name]), name), device, name)
    for key in ("resampler", "image_proj"):
        if key in cfg:
            assign(modules.resampler,
                   resampler_entries(modules.resampler, load_torch_file(cfg[key])), device,
                   key, reshape=("latents", "dummy_tokens"))

    if ("diffsensei_ckpt" in cfg or "ip_adapter" in cfg) and _on_meta(modules.unet):
        modules.fill_missing_params(device)   # the overlays need a UNet to overlay

    if "diffsensei_ckpt" in cfg:
        ckpt = load_torch_file(cfg["diffsensei_ckpt"])
        assign(modules.resampler, resampler_entries(modules.resampler, ckpt["image_proj"]),
               device, "image_proj", reshape=("latents", "dummy_tokens"))
        unet_sd = strip_module_prefix(ckpt["unet_trained"])
        if "conv_in.weight" in unet_sd:
            entries, _ = unet_entries(modules.unet, unet_sd)
        else:
            entries = unet_overlay_entries(modules.unet, unet_sd)
        assign(modules.unet, entries, device, "unet_trained")

    if "ip_adapter" in cfg:
        sd = load_torch_file(cfg["ip_adapter"])
        if "ip_adapter" not in sd:            # flat safetensors with prefixes
            sd = split_prefixed(sd, ("image_proj", "ip_adapter"))
        assign(modules.resampler, resampler_entries(modules.resampler, sd["image_proj"]),
               device, "image_proj", reshape=("latents", "dummy_tokens"))
        assign(modules.unet, ip_adapter_entries(modules.unet.config,
                                                strip_module_prefix(sd["ip_adapter"])),
               device, "ip_adapter")
    return modules


def _on_meta(module: nn.Module) -> bool:
    return any(p.is_meta for p in module.parameters())


def _exported_file(source: str) -> Optional[str]:
    """The ``train/checkpoint.py::export_weights`` file that ``source`` is or
    holds (a directory with exactly one ``*.pt`` file), else None."""
    if os.path.isdir(source):
        found = [f for f in os.listdir(source) if f.endswith(".pt")]
        return os.path.join(source, found[0]) if len(found) == 1 else None
    return source if os.path.isfile(source) and source.endswith((".pt", ".pth")) else None


def load_exported(modules, path: str, device=None):
    """Overlay a file of ``export_weights`` (the train CLI's trainables,
    ``unet.<name>`` / ``resampler.<name>``) onto ``modules``; the JAX
    package's Orbax weights directory in the port. Components still on meta
    are zero-filled first, as the JAX loader fills them to restore into."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    groups = split_prefixed(sd, ("unet", "resampler"))
    stray = [k for k in sd if not k.startswith(("unet.", "resampler."))]
    if stray:
        raise ValueError(f"{path}: not an export of unet / resampler weights: {stray[:4]}")
    device = device if device is not None else modules.device
    if _on_meta(modules.unet) or _on_meta(modules.resampler):
        modules.fill_missing_params(device)
    for name, group in groups.items():
        mod = getattr(modules, name)
        unknown = set(group) - set(mod.state_dict().keys())
        if unknown:
            raise KeyError(f"{path}: {sorted(unknown)[:4]} name no parameter of the {name}")
        if group:
            assign(mod, group, device, name)
    return modules


def load_weights_any(modules, source: str, device=None):
    """Dispatch a ``--weights`` argument: a YAML file mapping components to
    paths (relative ones against the YAML's directory) for
    :func:`apply_ported_weights`; a released artifact directory (holds
    ``image_generator/``); a file of ``train/checkpoint.py::export_weights``
    or a directory holding one. Anything else raises."""
    source = os.fspath(source)
    if os.path.isfile(source) and source.endswith((".yaml", ".yml")):
        import yaml

        with open(source) as f:
            cfg = yaml.safe_load(f) or {}
        base = os.path.dirname(os.path.abspath(source))
        cfg = {k: v if os.path.isabs(str(v)) else os.path.join(base, str(v))
               for k, v in cfg.items()}
        return apply_ported_weights(modules, cfg, device)
    if os.path.isdir(os.path.join(source, "image_generator")):
        return apply_ported_weights(modules, {"ckpt_path": source}, device)
    exported = _exported_file(source)
    if exported is not None:
        return load_exported(modules, exported, device)
    raise ValueError(f"unrecognized weights source: {source}")


# ---------------------------------------------------------------------------
# the SEED-X agent
# ---------------------------------------------------------------------------
AGENT_GROUPS = ("llm", "input_resampler", "output_resampler")


def split_agent_ckpt(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A ``ContinuousLVLM`` checkpoint (``llm.`` / ``input_resampler.`` /
    ``output_resampler.`` prefixes, ``module.`` stripped first) -> its
    groups."""
    return split_prefixed(strip_module_prefix(sd), AGENT_GROUPS)


def agent_entries(agent, groups: Mapping[str, Mapping[str, torch.Tensor]]
                  ) -> Dict[str, StateDict]:
    """The port's state dicts of the groups a checkpoint holds (an empty
    group is left out)."""
    out = {}
    if groups["llm"]:
        out["llm"] = llama_entries(agent.llm, groups["llm"])
    for name in ("input_resampler", "output_resampler"):
        if groups[name]:
            out[name] = take(getattr(agent, name), groups[name], name)
    return out


def load_agent_weights(agent, path: str, device=None):
    """Load a ``ContinuousLVLM`` checkpoint (the reference's
    ``mllm/agent/pytorch_model.bin``: HF or peft LLaMA names, ``module.``
    prefixes) into ``agent`` and return it; a group the file lacks keeps the
    agent's weights. A module on meta loads onto ``device``."""
    groups = split_agent_ckpt(load_torch_file(path))
    for name, entries in agent_entries(agent, groups).items():
        assign(getattr(agent, name), entries, device, name)
    return agent
