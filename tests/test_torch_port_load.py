"""The port's checkpoint loaders (``diffsensei_tpu_torch/utils/load.py``)
against the JAX package's (``diffsensei_tpu/utils/load.py``), on the CPU.

Checkpoints are written by the test from seeded JAX trees: the UNet, VAE,
Resampler, agent and IP-Adapter files by ``diffsensei_tpu/utils/export_torch.py``,
the CLIP text, CLIP vision and ViTMAE files by the port's ``from_jax`` (with
keys the porters never read added: ``position_ids``, ``visual_projection``,
a ViTMAE decoder), each as a ``torch.save`` ``.bin`` and as ``.safetensors``
from the ``safetensors`` package (so the port's own reader is held against
the official writer). Both packages load the same files; every state dict
the port loads must equal ``from_jax`` of the JAX-loaded tree exactly.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from diffsensei_tpu.utils import export_torch as jexport
from diffsensei_tpu.utils import load as jload

from diffsensei_tpu_torch.models.mllm import quant as tquant
from diffsensei_tpu_torch.models.mllm import seed_x as tseed
from diffsensei_tpu_torch.pipelines.pipeline import (
    DiffSenseiPipeline, PipelineModules, tiny_configs)
from diffsensei_tpu_torch.serve import api as tapi
from diffsensei_tpu_torch.serve import cli as tcli
from diffsensei_tpu_torch.train import cli as tcli_train
from diffsensei_tpu_torch.train import optim as toptim
from diffsensei_tpu_torch.train.checkpoint import export_weights
from diffsensei_tpu_torch.utils import from_jax
from diffsensei_tpu_torch.utils import load as tload
from diffsensei_tpu_torch.utils.tokenizer import CLIPTokenizer

from tests.test_torch_port_tokenizer import write_clip_vocab
from tests.torch_port_util import (agents, llama_tokenizer_dir, record_servers, spec_fields,
                                   tiny_pipelines)

torch.set_num_threads(1)
safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

COMPONENTS = ("unet", "vae", "text_encoder", "text_encoder_2", "image_encoder",
              "magi_encoder", "resampler")


def mae_configs():
    """The tiny configs with the Magi encoder in the ViTMAE layout (no
    embedding LayerNorm), which the JAX loader's ``port_vitmae`` reads."""
    cfgs = tiny_configs()
    cfgs["magi_encoder"] = dataclasses.replace(cfgs["magi_encoder"], use_pre_layernorm=False)
    return cfgs


@pytest.fixture(scope="module")
def ref():
    """The JAX tiny modules (ViTMAE-layout Magi) with seeded random trees:
    the files' source for the comparisons with the JAX loaders."""
    jpipe, _ = tiny_pipelines(magi_vitmae=True)
    return jpipe.m


@pytest.fixture(scope="module")
def std():
    """The JAX tiny modules of ``PipelineModules.tiny``'s configs (a
    CLIP-layout Magi encoder), for the CLIs' tiny preset."""
    jpipe, _ = tiny_pipelines()
    return jpipe.m


def port_sd(jm, name, tree=None):
    """``from_jax`` of component ``name``'s JAX tree (``tree`` or ``jm``'s)."""
    mod = getattr(jm, name)
    tree = getattr(jm, f"{name}_params") if tree is None else tree
    if name == "unet":
        return from_jax.sdxl_unet(tree, mod.config)
    if name == "vae":
        return from_jax.vae(tree, mod.config)
    if name.startswith("text_encoder"):
        return from_jax.clip_text(tree, mod.config.num_layers)
    if name == "resampler":
        return from_jax.resampler(tree, mod.config.depth)
    return from_jax.vision_encoder(tree, mod.config)


def file_sds(jm, merged_ip=False):
    """Each component's checkpoint state dict (numpy, reference names), with
    the keys the porters never read."""
    sds = {
        "unet": jexport.export_sdxl_unet_sd(jm.unet_params, jm.unet.config,
                                            ip_in_processor=not merged_ip),
        "vae": jexport.export_vae_sd(jm.vae_params, jm.vae.config),
        "resampler": jexport.export_resampler_sd(jm.resampler_params,
                                                 jm.resampler.config.depth),
    }
    for name in ("text_encoder", "text_encoder_2", "image_encoder", "magi_encoder"):
        sds[name] = port_sd(jm, name)
    for name in ("text_encoder", "text_encoder_2"):
        sds[name]["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    sds["image_encoder"]["visual_projection.weight"] = np.ones((8, 32), np.float32)
    sds["magi_encoder"]["decoder.decoder_pred.weight"] = np.ones((12, 16), np.float32)
    return sds


def save(sd, path):
    """A numpy state dict as ``.safetensors`` (the official writer) or as a
    ``torch.save`` file, by ``path``'s suffix."""
    path = os.fspath(path)
    if path.endswith(".safetensors"):
        safetensors_numpy.save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)
    else:
        torch.save(_tensors(sd), path)
    return path


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def jax_apply(jm, cfg):
    """The JAX loader over a copy of ``jm``."""
    return jload.apply_ported_weights(dataclasses.replace(jm), cfg)


def port_modules(init="none"):
    return PipelineModules.build(mae_configs(), device="cpu", init=init)


def port_apply(cfg, init="none"):
    return tload.apply_ported_weights(port_modules(init), cfg)


def assert_equal(mod, want, what=""):
    got = mod.state_dict()
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.array(v, np.float32))), f"{what} {k}"


# ---------------------------------------------------------------------------
# reading files
# ---------------------------------------------------------------------------
def test_safetensors_reader_matches_the_official_one(tmp_path):
    g = torch.Generator().manual_seed(0)
    sd = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
          "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
          "i8": torch.randint(-128, 127, (9,), dtype=torch.int8, generator=g),
          "u8": torch.randint(0, 255, (3, 3), dtype=torch.uint8, generator=g),
          "i64": torch.arange(5), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
          "odd_u8": torch.arange(3, dtype=torch.uint8), "after_odd": torch.randn(4, generator=g)}
    path = os.fspath(tmp_path / "x.safetensors")
    safetensors_torch.save_file(sd, path, metadata={"format": "pt"})
    want = safetensors_torch.load_file(path)
    got = tload.read_safetensors(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    assert tload.load_torch_file(path).keys() == want.keys()


# ---------------------------------------------------------------------------
# every component, both formats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", [".bin", ".safetensors"])
def test_each_component_loads_what_jax_loads(ref, tmp_path, fmt):
    cfg = {name: save(sd, tmp_path / f"{name}{fmt}") for name, sd in file_sds(ref).items()}
    jm = jax_apply(ref, cfg)
    tm = port_apply(cfg)
    for name in COMPONENTS:
        mod = getattr(tm, name)
        assert_equal(mod, port_sd(jm, name), name)
        assert not mod.training and not any(p.requires_grad for p in mod.parameters())


def _artifact(jm, root, merged_ip=False, drop=()):
    """A released artifact directory (``image_generator/...``)."""
    sds = file_sds(jm, merged_ip)
    for key in drop:
        sds["unet"] = {k: v for k, v in sds["unet"].items() if key not in k}
    gen = root / "image_generator"
    files = {"unet": "unet/pytorch_model.bin",
             "resampler": "image_proj_model/pytorch_model.bin",
             "vae": "vae/diffusion_pytorch_model.safetensors",
             "text_encoder": "text_encoder/model.safetensors",
             "text_encoder_2": "text_encoder_2/model.safetensors",
             "image_encoder": "clip_image_encoder/model.safetensors",
             "magi_encoder": "magi_image_encoder/model.safetensors"}
    for name, rel in files.items():
        (gen / rel).parent.mkdir(parents=True, exist_ok=True)
        save(sds[name], gen / rel)
    return root


@pytest.fixture(scope="module")
def artifact(ref, tmp_path_factory):
    return _artifact(ref, tmp_path_factory.mktemp("artifact"))


@pytest.fixture(scope="module")
def loaded(ref, artifact):
    """(JAX pipeline, port pipeline) loaded from the artifact directory."""
    from diffsensei_tpu.pipelines import pipeline as jpipeline

    jm = jax_apply(ref, {"ckpt_path": str(artifact)})
    tm = port_apply({"ckpt_path": str(artifact)})
    return jpipeline.DiffSenseiPipeline(jm), DiffSenseiPipeline(tm)


def test_the_artifact_layout_loads_every_component(loaded):
    jpipe, tpipe = loaded
    for name in COMPONENTS:
        assert_equal(getattr(tpipe.m, name), port_sd(jpipe.m, name), name)


def test_the_panel_from_loaded_weights_matches_jax(loaded, monkeypatch):
    """Per-step latents within ``test_torch_port_pipeline``'s bound and the
    served images within 5e-4, from the stacks both packages loaded."""
    from diffsensei_tpu.serve import api as japi
    from tests import test_torch_port_pipeline as tp

    jpipe, tpipe = loaded
    req = tp._request(tapi)
    server = tapi.DiffSenseiServer(tpipe)
    pixels = server._preprocess_characters(req.character_images)
    lat0 = tp._jax_draw(req, jpipe)
    want = tp._jax_step_latents(jpipe, req, pixels.numpy(), lat0)
    got = []
    tpipe(height=tp.HEIGHT, width=tp.WIDTH, num_inference_steps=tp.STEPS, guidance_scale=7.5,
          num_samples=req.num_samples, latents=torch.from_numpy(lat0),
          ip_pixel_values=pixels, ip_bbox=req.ip_bbox, ip_scale=req.ip_scale,
          dialog_bbox=req.dialog_bbox, prompt_ids=req.prompt_ids, return_latents=True,
          negative_prompt="", callback=lambda i, lat: got.append(lat.numpy().copy()))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0,
                                   err_msg=f"step {i}")
    jimg = japi.DiffSenseiServer(jpipe).generate(tp._request(japi))
    monkeypatch.setattr(server, "initial_latents", lambda seed, shape: torch.from_numpy(lat0))
    timg = server.generate(req)
    assert np.isfinite(timg).all()
    np.testing.assert_allclose(timg, jimg, atol=5e-4, rtol=0)


# ---------------------------------------------------------------------------
# the UNet's special cases and the auxiliary formats
# ---------------------------------------------------------------------------
def test_merged_ip_names_load(ref, tmp_path):
    sd = file_sds(ref, merged_ip=True)["unet"]
    assert any(".attn2.to_k_ip." in k for k in sd)
    cfg = {"unet": save(sd, tmp_path / "unet.bin")}
    assert_equal(port_apply(cfg).unet, port_sd(jax_apply(ref, cfg), "unet"))


def test_a_plain_sdxl_unet_seeds_its_ip_projections(ref, tmp_path, capsys):
    sd = {k: v for k, v in file_sds(ref)["unet"].items() if "_ip." not in k}
    cfg = {"unet": save(sd, tmp_path / "unet.safetensors")}
    want = port_sd(jax_apply(ref, cfg), "unet")
    jax_line = [ln for ln in capsys.readouterr().out.splitlines() if "seeded" in ln]
    unet = port_apply(cfg).unet
    assert_equal(unet, want)
    port_line = [ln for ln in capsys.readouterr().out.splitlines() if "seeded" in ln]
    assert port_line == jax_line and len(jax_line) == 1
    k = "mid_block.attentions.0.transformer_blocks.0.attn2."
    assert torch.equal(unet.state_dict()[k + "processor.to_k_ip.weight"],
                       unet.state_dict()[k + "to_k.weight"])


def test_a_missing_dialog_embedding_is_zeros(ref, tmp_path):
    sd = {k: v for k, v in file_sds(ref)["unet"].items() if k != "dialog_bbox_embedding"}
    cfg = {"unet": save(sd, tmp_path / "unet.bin")}
    unet = port_apply(cfg).unet
    assert_equal(unet, port_sd(jax_apply(ref, cfg), "unet"))
    assert not unet.dialog_bbox_embedding.any()


def test_a_missing_required_key_raises(ref, tmp_path):
    sd = {k: v for k, v in file_sds(ref)["vae"].items() if k != "decoder.conv_in.weight"}
    with pytest.raises(KeyError, match="decoder.conv_in.weight"):
        port_apply({"vae": save(sd, tmp_path / "vae.safetensors")})
    with pytest.raises(KeyError):
        jax_apply(ref, {"vae": os.fspath(tmp_path / "vae.safetensors")})


def test_an_unknown_weights_key_raises(ref):
    with pytest.raises(ValueError, match="unknown weights keys"):
        port_apply({"unett": "x.bin"})
    with pytest.raises(ValueError, match="unknown weights keys"):
        jax_apply(ref, {"unett": "x.bin"})


def _other_trees(jm, seed=11):
    """Other random IP projections, dialog embedding and Resampler for the
    overlay formats (so an overlay visibly changes the base)."""
    from tests.torch_port_util import random_tree

    rng = np.random.default_rng(seed)
    unet = jax.tree.map(lambda x: np.asarray(x), jm.unet_params)
    unet = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32)
        if any(getattr(k, "key", None) in ("to_k_ip", "to_v_ip", "dialog_bbox_embedding")
               for k in path) else x, unet)
    manga = jm.manga
    res = random_tree(jm.resampler, jnp.zeros((1, manga.max_num_ips,
                                               jm.image_encoder.config.seq_len,
                                               jm.resampler.config.embedding_dim)),
                      jnp.zeros((1, manga.max_num_ips, jm.resampler.config.magi_embedding_dim)),
                      seed=seed)
    return unet, res


@pytest.mark.parametrize("full", [False, True], ids=["partial", "full"])
def test_diffsensei_ckpt_loads_what_jax_loads(ref, artifact, tmp_path, full):
    """The stage-2 ``{"image_proj", "unet_trained"}`` dict with ``module.``
    prefixes: a partial ``unet_trained`` overlays the IP projections and the
    dialog embedding, a full one (``conv_in`` present) replaces the UNet."""
    unet, res = _other_trees(ref)
    unet_sd = jexport.export_sdxl_unet_sd(unet, ref.unet.config)
    if not full:
        unet_sd = {k: v for k, v in unet_sd.items()
                   if "_ip." in k or k == "dialog_bbox_embedding"}
    ckpt = {"image_proj": {f"module.{k}": v for k, v in
                           jexport.export_resampler_sd(res, ref.resampler.config.depth).items()},
            "unet_trained": {f"module.{k}": v for k, v in unet_sd.items()}}
    path = os.fspath(tmp_path / "ckpt.bin")
    torch.save(_tensors(ckpt), path)
    cfg = {"ckpt_path": str(artifact), "diffsensei_ckpt": path}
    jm = jax_apply(ref, cfg)
    tm = port_apply(cfg)
    for name in ("unet", "resampler"):
        assert_equal(getattr(tm, name), port_sd(jm, name), name)
    assert not np.array_equal(port_sd(jm, "resampler")["latents"],
                              port_sd(ref, "resampler")["latents"])


def _ip_adapter_file(jm, path, flat):
    unet, res = _other_trees(jm, seed=12)
    sd = jexport.export_ip_adapter_sd(unet, res, jm.unet.config, jm.resampler.config.depth)
    if flat:
        sd = {f"{g}.{k}": v for g in sd for k, v in sd[g].items()}
        return save(sd, path.with_suffix(".safetensors"))
    torch.save(_tensors(sd), path.with_suffix(".bin"))
    return os.fspath(path.with_suffix(".bin"))


@pytest.mark.parametrize("flat", [False, True], ids=["torch_dict", "flat_safetensors"])
def test_ip_adapter_loads_what_jax_loads(ref, artifact, tmp_path, flat):
    cfg = {"ckpt_path": str(artifact), "ip_adapter": _ip_adapter_file(ref, tmp_path / "ip", flat)}
    jm = jax_apply(ref, cfg)
    tm = port_apply(cfg)
    for name in ("unet", "resampler"):
        assert_equal(getattr(tm, name), port_sd(jm, name), name)


def test_ip_adapter_rejects_mismatched_indices(ref, tmp_path):
    """An index past the processor list names no attn2 slot (the JAX
    ``test_port_ip_adapter_rejects_mismatched_indices``); an attn1 slot's
    index is skipped by both, as the reference's ModuleList load skips it."""
    unet, res = _other_trees(ref, seed=13)
    sd = jexport.export_ip_adapter_sd(unet, res, ref.unet.config, ref.resampler.config.depth)
    n = len(tload.attn_processor_slots(ref.unet.config))
    sd["ip_adapter"][f"{n + 1}.to_k_ip.weight"] = sd["ip_adapter"]["1.to_k_ip.weight"]
    path = os.fspath(tmp_path / "ip.bin")
    torch.save(_tensors(sd), path)
    with pytest.raises(ValueError, match="matched no attn2"):
        port_apply({"ip_adapter": path})
    with pytest.raises(ValueError, match="matched no attn2"):
        jax_apply(ref, {"ip_adapter": path})


def test_image_proj_loads_what_jax_port_image_proj_reads(tmp_path):
    """An ``ImageProjDummyModel`` checkpoint under the reference names
    (``module.`` prefixed, ``dummy_tokens`` ``[1, N, C]``) loads into the
    port's module as the JAX ``port_image_proj`` reads it."""
    from diffsensei_tpu.models.projection import ImageProjDummyModel as JProj
    from diffsensei_tpu.utils.port_torch import port_image_proj
    from diffsensei_tpu_torch.models.projection import ImageProjDummyModel as TProj
    from tests.torch_port_util import random_tree

    jproj = JProj(cross_attention_dim=16, num_tokens=4, num_dummy_tokens=3)
    tree = random_tree(jproj, jnp.zeros((1, 2, 24)), jnp.zeros((1, 2, 12)), seed=12)
    sd = from_jax.to_tensors(from_jax.image_proj(tree))
    sd["dummy_tokens"] = sd["dummy_tokens"][None]
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "proj.bin")
    mods = PipelineModules.tiny(device="cpu")
    mods.resampler = TProj(24, 12, cross_attention_dim=16, num_tokens=4, num_dummy_tokens=3)
    tload.apply_ported_weights(mods, {"image_proj": os.fspath(tmp_path / "proj.bin")})
    want = from_jax.image_proj(port_image_proj({k: v.numpy() for k, v in sd.items()}))
    got = mods.resampler.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value.reshape(got[name].shape), name)


def test_processor_slots_are_the_jax_ones(ref):
    from diffsensei_tpu.utils.port_torch import attn_processor_slots

    def diffusers(mod, k):
        if mod is None:
            return None
        if mod == "mid_attn":
            base = "mid_block.attentions.0"
        else:
            side, level, _, j = mod.split("_")
            base = f"{side}_blocks.{level}.attentions.{j}"
        return f"{base}.transformer_blocks.{k}.attn2.processor"

    want = [diffusers(m, k) for m, k in attn_processor_slots(ref.unet.config)]
    assert tload.attn_processor_slots(ref.unet.config) == want
    names = set(PipelineModules.tiny(device="meta", init="none").unet.state_dict())
    assert all(f"{n}.to_k_ip.weight" in names for n in want if n)


# ---------------------------------------------------------------------------
# load_weights_any
# ---------------------------------------------------------------------------
def test_load_weights_any_reads_yaml_artifacts_and_exports(ref, artifact, tmp_path):
    sds = file_sds(ref)
    (tmp_path / "w").mkdir()
    for name in ("unet", "resampler"):
        save(sds[name], tmp_path / "w" / f"{name}.safetensors")
    (tmp_path / "w" / "weights.yaml").write_text("unet: unet.safetensors\n"
                                                 "resampler: resampler.safetensors\n")
    tm = tload.load_weights_any(port_modules(), os.fspath(tmp_path / "w" / "weights.yaml"))
    jm = jload.load_weights_any(dataclasses.replace(ref),
                                os.fspath(tmp_path / "w" / "weights.yaml"))
    for name in ("unet", "resampler"):
        assert_equal(getattr(tm, name), port_sd(jm, name), name)
    assert tm.vae.decoder.conv_in.weight.is_meta           # not in the YAML

    tm = tload.load_weights_any(port_modules(), str(artifact))
    jm = jload.load_weights_any(dataclasses.replace(ref), str(artifact))
    for name in COMPONENTS:
        assert_equal(getattr(tm, name), port_sd(jm, name), name)

    # the train CLI's export: trainables by "unet." / "resampler." name, over the
    # current weights; a file, or a directory holding one
    exported = {f"unet.{k}": torch.full_like(p, 0.5) for k, p in tm.unet.named_parameters()
                if "_ip" in k}
    exported["resampler.latents"] = torch.full_like(tm.resampler.latents, -1.0)
    (tmp_path / "export").mkdir()
    export_weights(os.fspath(tmp_path / "export" / "weights.pt"), exported)
    for source in (tmp_path / "export" / "weights.pt", tmp_path / "export"):
        tm2 = tload.load_weights_any(tload.load_weights_any(port_modules(), str(artifact)),
                                     os.fspath(source))
        got = {f"unet.{k}": v for k, v in tm2.unet.state_dict().items()}
        got.update({f"resampler.{k}": v for k, v in tm2.resampler.state_dict().items()})
        assert all(torch.equal(got[k], v) for k, v in exported.items())
        assert torch.equal(tm2.unet.conv_in.weight, tm.unet.conv_in.weight)
    with pytest.raises(ValueError, match="unrecognized weights source"):
        tload.load_weights_any(port_modules(), os.fspath(tmp_path / "nothing.ckpt"))


# ---------------------------------------------------------------------------
# fill_missing_params and the constructors' init
# ---------------------------------------------------------------------------
def test_fill_missing_params_zero_fills_what_jax_zero_fills(ref, tmp_path):
    """Load a UNet only, then fill: the same components zero-filled as the
    JAX ``fill_missing_params`` (trees still None); ``init="zeros"`` is all
    zeros, as the JAX ``sdxl(init="zeros")``."""
    cfg = {"unet": save(file_sds(ref)["unet"], tmp_path / "unet.bin")}
    jm = dataclasses.replace(ref, **{f"{n}_params": None for n in COMPONENTS})
    jm = jload.apply_ported_weights(jm, cfg)
    jm.fill_missing_params(jax.random.key(0))
    tm = port_apply(cfg)
    assert not any(p.is_meta for p in tm.unet.parameters())
    assert tm.vae.decoder.conv_in.weight.is_meta
    tm.fill_missing_params()
    for name in COMPONENTS:
        want = port_sd(jm, name)
        if name != "unet":
            assert all(not np.any(v) for v in want.values()), name
        assert_equal(getattr(tm, name), want, name)
    zeros = port_modules("zeros")
    assert all(not p.any() for m in zeros.networks().values() for p in m.parameters())
    with pytest.raises(ValueError, match="init must be"):
        PipelineModules.tiny(device="cpu", init="ones")


def test_loaded_weights_keep_dtype_device_and_layout(ref, artifact):
    """A bf16, channels_last build on the meta device (as ``sdxl(init=
    "none")`` makes one) loads with every parameter's dtype and strides those
    of the same build with random weights; the VAE stays fp32."""
    want = PipelineModules.build(mae_configs(), torch.bfloat16, "cpu", channels_last=True)
    got = PipelineModules.build(mae_configs(), torch.bfloat16, "cpu", init="none",
                                channels_last=True)
    tload.load_weights_any(got, str(artifact))
    for name, mod in want.networks().items():
        ps = dict(getattr(got, name).named_parameters())
        for k, p in mod.named_parameters():
            q = ps[k]
            assert (q.dtype, q.device, q.stride()) == (p.dtype, p.device, p.stride()), (name, k)
    assert got.vae.decoder.conv_in.weight.dtype == torch.float32
    w = got.unet.conv_in.weight
    assert w.is_contiguous(memory_format=torch.channels_last) and not w.is_contiguous()


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def agent_pair():
    from diffsensei_tpu.core.config import AgentConfig

    return agents(AgentConfig.tiny())


def _peft(sd):
    """HF LLaMA names -> peft's (``base_model.model.``, ``.base_layer.``,
    ``lora_A.default``)."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("llm."):
            out[k] = v
            continue
        rest = k[len("llm."):]
        if ".lora_" in rest:
            rest = rest.replace(".lora_A.weight", ".lora_A.default.weight").replace(
                ".lora_B.weight", ".lora_B.default.weight")
        elif rest.endswith("_proj.weight") and ".layers." in rest:
            rest = rest.replace("_proj.weight", "_proj.base_layer.weight")
        out[f"llm.base_model.model.{rest}"] = v
    return out


@pytest.mark.parametrize("names", ["plain", "module", "peft"])
def test_agent_weights_load_what_jax_loads(agent_pair, tmp_path, names):
    jagent, _ = agent_pair
    sd = jexport.export_agent_ckpt(jagent.llm_params, jagent.input_resampler_params,
                                   jagent.output_resampler_params,
                                   jagent.config.llm.num_layers)
    if names == "module":
        sd = {f"module.{k}": v for k, v in sd.items()}
    elif names == "peft":
        sd = _peft(sd)
        assert any(".base_layer." in k for k in sd) and any(".default." in k for k in sd)
    path = os.fspath(tmp_path / "agent.bin")
    torch.save(_tensors(sd), path)
    want = from_jax.agent(jload.load_agent_weights(jagent, path))
    _, tagent = agents(jagent.config, seed=5)          # other weights to load over
    tload.load_agent_weights(tagent, path)
    for name, sd_want in want.items():
        assert_equal(getattr(tagent, name), sd_want, name)


@pytest.mark.parametrize("num_kv_heads", [4, 2])
def test_hf_llama_state_dict_loads_to_hf_logits(num_kv_heads):
    """A randomly initialised ``transformers.LlamaForCausalLM``'s state dict,
    loaded by name (``llama_entries``), gives HF's logits (the JAX package's
    ``tests/test_port_llama.py`` for the port)."""
    from diffsensei_tpu_torch.core.config import LlamaConfig
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM

    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=num_kv_heads,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=False)).eval()
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=num_kv_heads, max_position_embeddings=128)
    with torch.device("meta"):
        llm = LlamaForCausalLM(cfg, lora_rank=4)
    tload.assign(llm, tload.llama_entries(llm, hf.state_dict()), "cpu", "llm")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(ids).logits
        got, _, _ = llm(ids)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_host_quantization_is_the_bytes_of_quantize_agent(agent_pair, tmp_path, bits):
    """``--quantize-llm``'s load: an agent on the meta device, the
    checkpoint quantized on the host, gives ``quantize_agent``'s bytes for
    the same agent loaded in memory; a checkpoint without a resampler group
    raises."""
    jagent, tagent = agent_pair
    sd = jexport.export_agent_ckpt(jagent.llm_params, jagent.input_resampler_params,
                                   jagent.output_resampler_params,
                                   jagent.config.llm.num_layers)
    path = os.fspath(tmp_path / "agent.bin")
    torch.save(_tensors(sd), path)
    want = tquant.quantize_agent(tagent, bits=bits)
    meta = tseed.ContinuousLVLM.build(tagent.config, device="cpu", init="none")
    assert meta.llm.embed_tokens.weight.is_meta
    entries = tload.agent_entries(meta, tload.split_agent_ckpt(tload.load_torch_file(path)))
    got = tquant.quantize_agent_on_host(meta, entries, bits=bits, device="cpu")
    for name in ("llm", "input_resampler", "output_resampler"):
        w, g = getattr(want, name).state_dict(), getattr(got, name).state_dict()
        assert w.keys() == g.keys(), name
        for k in w:
            assert w[k].dtype == g[k].dtype and torch.equal(w[k], g[k]), (name, k)
    assert got.llm.quantized == ("int4" if bits == 4 else "int8")
    torch.save(_tensors({k: v for k, v in sd.items() if not k.startswith("output_")}), path)
    entries = tload.agent_entries(meta, tload.split_agent_ckpt(tload.load_torch_file(path)))
    with pytest.raises(ValueError, match="output_resampler"):
        tquant.quantize_agent_on_host(meta, entries, bits=bits, device="cpu")


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------
def _folded_vocab(path, pad_token="<|endoftext|>"):
    """A CLIP tokenizer directory whose ids fold into the tiny text encoders'
    256 tokens (ids mod 254; the special tokens at 254 and 255)."""
    write_clip_vocab(path, pad_token=pad_token)
    vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
    special = {"<|startoftext|>": 254, "<|endoftext|>": 255}
    vocab = {t: special.get(t, i % 254) for t, i in vocab.items()}
    (path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    return path


def _train_run(tmp_path, weights, extra_model="", tokenizers=True):
    from tests.test_torch_port_train import _write_run

    cfg = _write_run(tmp_path, max_train_steps=1)
    text = open(cfg).read()
    text = text.replace("model:\n", "weights:\n" + "".join(
        f"  {k}: {v}\n" for k, v in weights.items()) + "model:\n" + extra_model)
    if tokenizers:
        t1, t2 = _folded_vocab(tmp_path / "tok1"), _folded_vocab(tmp_path / "tok2", "!")
        text = text.replace("train_data:\n", f"train_data:\n  tokenizer_path: {t1}\n"
                                             f"  tokenizer_2_path: {t2}\n")
    open(cfg, "w").write(text)
    return cfg


def test_train_cli_loads_weights_and_tokenizers_and_steps_as_jax(std, tmp_path, monkeypatch):
    """A tiny stage-2 run with a ``weights:`` group and tokenizer files: the
    first batch's token ids are the JAX dataset's with ``transformers``'
    tokenizer (the JAX CLI's), and the step's loss on that batch is the JAX
    step's loss (the same draws) within 5e-4."""
    from diffsensei_tpu.data.bucket_dataset import (
        BucketDatasetConfig as JDsCfg, MangaTrainSizeBucketDataset as JDataset)
    from diffsensei_tpu.models.schedulers import DDPMSchedule as JDDPM
    from diffsensei_tpu.train import cli as jcli
    from diffsensei_tpu.train import diffusion as jdiff
    from diffsensei_tpu_torch.train import diffusion as tdiff
    from tests.test_torch_port_train import _frozen, _jax_draws

    ref = std
    sds = file_sds(ref)
    weights = {name: save(sds[name], tmp_path / f"{name}.safetensors") for name in COMPONENTS}
    cfg = _train_run(tmp_path, weights)
    seen = {}
    make = tdiff.make_stage2_step

    def recording(*args, **kwargs):
        """The CLI's step, its first loss on the JAX step's draws for the batch."""
        loss_fn = make(*args, **kwargs).loss_fn

        def fixed_draws(frozen, batch, generator=None, **kw):
            if "loss" not in seen:
                np_batch = {k: v.numpy() for k, v in batch.items()}
                draws = _jax_draws(jm, np_batch, jax.random.key(1))
                kw = {k: torch.from_numpy(v.copy()) for k, v in draws.items()}
                out = loss_fn(frozen, batch, **kw)
                seen.update(batch=np_batch, loss=float(out[0].detach()))
                return out
            return loss_fn(frozen, batch, generator, **kw)
        return tdiff._make_step(fixed_draws)

    # the JAX loader reads a Magi file as ViTMAE; the tiny preset's Magi is
    # CLIP-shaped, which the port loads by name: the JAX side takes its tree
    jm = jax_apply(ref, {k: v for k, v in weights.items() if k != "magi_encoder"})
    jm.magi_encoder_params = ref.magi_encoder_params
    monkeypatch.setattr(tcli_train, "make_stage2_step", recording)
    tcli_train.main(["--config", cfg, "--device", "cpu", "--log_dir",
                     os.fspath(tmp_path / "logs")])
    batch = seen["batch"]

    # the JAX dataset with transformers' tokenizers gives the same first batch
    import yaml
    td = yaml.safe_load(open(cfg))["train_data"]
    tok = jcli._load_tokenizer(td["tokenizer_path"], 256)
    tok_2 = jcli._load_tokenizer(td["tokenizer_2_path"], 256)
    jds = JDataset(ann_path=td["ann_path"], image_root=td["image_root"], tokenize=tok,
                   tokenize_2=tok_2, config=JDsCfg(
                       max_num_ips=ref.manga.max_num_ips, max_num_ip_sources=2,
                       max_num_dialogs=ref.manga.max_num_dialogs, batch_size=4))
    first = next(iter(jds.batches(shuffle=True, seed=0, num_workers=0)))
    for key in ("text_input_ids", "text_input_ids_2", "pixel_values", "ip_bbox"):
        assert np.array_equal(first[key], batch[key]), key
    assert (batch["text_input_ids"][:, 0] == 254).all()

    jfrozen, _ = _frozen(jm, PipelineModules.tiny(device="cpu"))
    jstep = jdiff.make_stage2_step(jm.unet, jm.resampler, JDDPM(), jdiff.Stage2Config(
        manga=ref.manga, max_num_sources=2, ip_contrastive="fast"))
    jloss, _ = jstep.loss_fn({"unet": jm.unet_params, "resampler": jm.resampler_params},
                             jfrozen, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.key(1))
    np.testing.assert_allclose(seen["loss"], float(jloss), atol=5e-4, rtol=5e-4)


def test_train_cli_param_dtype(std, tmp_path):
    """The tiny preset ignores ``param_dtype: bfloat16`` (as the JAX CLI
    does): fp32 trainables and the float32 run's loss. The sdxl preset,
    built on the meta device, gives bf16 trainables with no fp32 copies."""
    weights = {"unet": save(file_sds(std)["unet"], tmp_path / "unet.bin")}
    losses = {}
    for dtype in ("float32", "bfloat16"):
        run = tmp_path / dtype
        run.mkdir()
        cfg = _train_run(run, weights, f"  param_dtype: {dtype}\n", tokenizers=False)
        state = tcli_train.main(["--config", cfg, "--device", "cpu", "--log_dir",
                                 os.fspath(run / "logs")])
        assert all(p.dtype == torch.float32 for p in state.params.values())
        losses[dtype] = json.loads((run / "logs" / "metrics.jsonl").read_text())["loss"]
    assert losses["float32"] == losses["bfloat16"]

    mcfg = {"preset": "sdxl", "init": "none", "param_dtype": "bfloat16"}
    mods = tcli_train.build_models(mcfg, device="meta")
    trainable, frozen = toptim.partition_params(
        mods.unet, toptim.unet_trainable_mask(mods.unet, "new"),
        tcli_train.trainable_dtype(mcfg))
    assert trainable and all(p.dtype == torch.bfloat16 and p.requires_grad
                             for p in trainable.values())
    assert tcli_train.trainable_dtype({"preset": "sdxl"}) == torch.float32
    with pytest.raises(ValueError):
        tcli_train.trainable_dtype({"param_dtype": "float16"})


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_serves_loaded_weights_with_tokenizer_files(std, agent_pair, tmp_path,
                                                             monkeypatch):
    """``--weights`` and ``--tokenizer`` write the panel the port's server
    gives for the same loaded modules; the agent flags load (int4 on the
    host), and with ``--mllm-tokenizer`` the server is built with the
    directory's token spec."""
    jagent, _ = agent_pair
    agent_path = os.fspath(tmp_path / "agent.bin")
    torch.save(_tensors(jexport.export_agent_ckpt(
        jagent.llm_params, jagent.input_resampler_params, jagent.output_resampler_params,
        jagent.config.llm.num_layers)), agent_path)
    artifact = _artifact(std, tmp_path / "artifact")
    tok1, tok2 = _folded_vocab(tmp_path / "tok1"), _folded_vocab(tmp_path / "tok2", "!")
    char = tmp_path / "char.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (60, 40, 3), np.uint8)).save(char)
    out = tmp_path / "p.png"
    args = ["--device", "cpu", "--preset", "tiny", "--weights", str(artifact),
            "--tokenizer", str(tok1), "--tokenizer-2", str(tok2),
            "--prompt", "A young girl stands in the rain!", "--negative-prompt", "blurry",
            "--height", "128", "--width", "128", "--steps", "2", "--seed", "4",
            "--char-image", str(char), "--ip-bbox", "0,0,0.5,1", "--dialog-bbox",
            "0.1,0,0.5,0.2", "--agent-weights", agent_path, "--quantize-llm",
            "--quantize-llm-bits", "4", "--out", str(out)]
    assert tcli.main(args) == [str(out)]

    mods = tload.load_weights_any(PipelineModules.tiny(device="cpu", seed=0), str(artifact))
    mods.tokenizer = CLIPTokenizer.from_pretrained(str(tok1))
    mods.tokenizer_2 = CLIPTokenizer.from_pretrained(str(tok2))
    server = tapi.DiffSenseiServer(DiffSenseiPipeline(mods))
    want = server.generate_pil(tapi.GenerationRequest(
        prompt="A young girl stands in the rain!", negative_prompt="blurry", height=128,
        width=128, num_inference_steps=2, seed=4,
        character_images=[Image.open(char).convert("RGB")], ip_bbox=[[0, 0, 0.5, 1]],
        dialog_bbox=[[0.1, 0, 0.5, 0.2]]))[0]
    assert np.array_equal(np.asarray(Image.open(out)), np.asarray(want))
    llama = llama_tokenizer_dir(tmp_path / "llama")
    built = record_servers(monkeypatch)
    assert tcli.main(args + ["--mllm-tokenizer", str(llama)]) == []
    assert len(built) == 1 and built[0]["agent"] is not None
    assert spec_fields(built[0]["mllm_spec"]) == spec_fields(
        tcli.mllm_spec_from_tokenizer(str(llama)))
