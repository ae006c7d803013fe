"""UNet LoRA and the int8 UNet of the port against the JAX package (CPU, fp32).

``LoRADense`` at rank > 0, ``merge_lora_params`` and ``quantize_unet_params``
are held to the JAX functions on the same trees: the merged and quantized
bytes equal, forwards within 5e-4 (the bound of ``test_torch_port_models.py``).
One stage-2 step in the ``lora`` mode matches the JAX step at 5e-4 of each
tensor's largest magnitude (``test_torch_port_train.py``), and the train CLI
trains, checkpoints, resumes and exports the adapters.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsensei_tpu.models import lora as jlora, quant_unet as jquant
from diffsensei_tpu.models.unet import UNetMangaModel as JUNet

from diffsensei_tpu_torch.models import lora as tlora, quant_unet as tquant
from diffsensei_tpu_torch.models.unet import UNetMangaModel as TUNet
from diffsensei_tpu_torch.train import cli
from diffsensei_tpu_torch.train.checkpoint import export_weights, load_weights
from diffsensei_tpu_torch.utils import from_jax

from tests.test_torch_port_train import _check_step, _write_run
from tests.torch_port_util import random_tree, tiny_pipelines

torch.set_num_threads(1)
RANK = 4


@pytest.mark.parametrize("bias", [True, False])
def test_lora_dense_matches_jax(bias):
    """At the UNet's scale, alpha = rank (the JAX default)."""
    jmod = jlora.LoRADense(24, lora_rank=RANK, use_bias=bias)
    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    tree = random_tree(jmod, jnp.zeros((1, 16)), seed=1)
    p = tree["params"]
    tmod = tlora.LoRADense(16, 24, bias=bias, lora_rank=RANK)
    sd = {"weight": p["kernel"].T, "lora_A.weight": p["lora_a"].T,
          "lora_B.weight": p["lora_b"].T, **({"bias": p["bias"]} if bias else {})}
    tmod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(tree, x)), atol=5e-4, rtol=0)


@pytest.fixture(scope="module")
def lora_stacks():
    """(JAX, port) tiny pipeline modules with the same weights, adapters of
    rank ``RANK``; the port's VAE carries the encoder too."""
    jpipe, tpipe = tiny_pipelines(lora_rank=RANK)
    jm, tm = jpipe.m, tpipe.m
    tm.vae.load_state_dict(from_jax.to_tensors(from_jax.vae(jm.vae_params, jm.vae.config)))
    return jm, tm


@pytest.fixture(scope="module")
def lora_unets(lora_stacks):
    """(JAX tiny UNet config, its LoRA tree, the port's UNet with its weights)."""
    jm, tm = lora_stacks
    return jm.unet.config, jm.unet_params, tm.unet


def _unet_inputs(cfg):
    rng = np.random.default_rng(6)
    m = cfg.manga
    return ([rng.normal(size=(2, 12, 10, 4)).astype(np.float32),
             np.array([700.0, 3.0], np.float32),
             rng.normal(size=(2, 77, 32)).astype(np.float32),
             rng.normal(size=(2, 16)).astype(np.float32),
             np.tile(np.array([[96, 80, 0, 0, 96, 80]], np.float32), (2, 1))],
            dict(ip_hidden_states=rng.normal(size=(2, m.num_context_image_tokens, 32))
                 .astype(np.float32), ip_scale=0.5))


def _port_forward(unet, args, kw):
    with torch.no_grad():
        return unet(*(torch.from_numpy(a) for a in args),
                    **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()}).numpy()


def test_lora_unet_matches_jax(lora_unets):
    cfg, tree, unet = lora_unets
    assert sum("lora_" in n for n, _ in unet.named_parameters()) == 2 * 4 * 2 * 4
    assert not any("_ip.lora" in n for n, _ in unet.named_parameters())
    args, kw = _unet_inputs(cfg)
    want = JUNet(cfg).apply(tree, *args, **kw)
    np.testing.assert_allclose(_port_forward(unet, args, kw), np.asarray(want), atol=5e-4,
                               rtol=0)


def test_merge_lora_gives_the_jax_bytes(lora_unets):
    cfg, tree, unet = lora_unets
    want = from_jax.sdxl_unet(jlora.merge_lora_params(tree), cfg)
    got = tlora.merge_lora_state_dict(unet.state_dict())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    merged = tquant.merge_lora(unet)
    assert merged.config.lora_rank == 0 and unet.config.lora_rank == RANK
    args, kw = _unet_inputs(cfg)
    np.testing.assert_allclose(_port_forward(merged, args, kw), _port_forward(unet, args, kw),
                               atol=5e-4, rtol=0)


def test_quantize_unet_gives_the_jax_bytes_and_forward(lora_unets):
    cfg, tree, unet = lora_unets
    jtree = jquant.quantize_unet_params(tree)
    want = from_jax.sdxl_unet(jtree, cfg)
    got = tquant.quantize_unet_state_dict(unet.state_dict())
    assert sorted(got) == sorted(want)
    assert sum(k.endswith("kernel_q") for k in got) == 4 * (4 + 4 + 2 + 2 + 2)
    for k, v in want.items():
        assert got[k].dtype == (torch.int8 if k.endswith("kernel_q") else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    qunet = tquant.quantize_unet(unet)
    assert qunet.quantized and not any("lora" in k for k in qunet.state_dict())
    assert tquant.tree_bytes(qunet) == jquant.tree_bytes(jtree)
    loaded = TUNet(dataclasses.replace(cfg, lora_rank=0), quantized=True)
    loaded.load_state_dict(from_jax.to_tensors(want))
    args, kw = _unet_inputs(cfg)
    jout = JUNet(dataclasses.replace(cfg, lora_rank=0), quantized=True).apply(jtree, *args, **kw)
    for port in (qunet, loaded):
        np.testing.assert_allclose(_port_forward(port, args, kw), np.asarray(jout), atol=5e-4,
                                   rtol=0)


def test_int8_unet_refuses_adapters(lora_unets):
    cfg = lora_unets[0]
    with pytest.raises(ValueError, match="merge LoRA"):
        TUNet(cfg, quantized=True)


def test_ensure_lora_init_redraws_only_dead_adapters(lora_unets):
    unet = TUNet(lora_unets[2].config)
    unet.load_state_dict(lora_unets[2].state_dict())
    assert tlora.ensure_lora_init(unet, seed=0) == 0
    mods = [m for m in unet.modules() if isinstance(m, tlora.LoRADense) and m.lora_rank]
    with torch.no_grad():
        for m in mods[:3]:
            m.lora_A.weight.zero_()
    assert tlora.ensure_lora_init(unet, seed=0) == 3
    a = torch.cat([m.lora_A.weight.flatten() for m in mods[:3]])
    assert a.abs().min() > 0 and 0.15 < float(a.detach().std()) < 0.35      # std 1 / rank
    assert all(not m.lora_B.weight.any() for m in mods[:3])
    assert all(m.lora_B.weight.any() for m in mods[3:])


def test_stage2_lora_step_matches_jax(lora_stacks):
    params = _check_step(*lora_stacks, stage=2, mode="lora", contrastive="fast")
    unet_names = [k for k in params if k.startswith("unet.")]
    assert unet_names and all("lora_" in k or "_ip" in k for k in unet_names)
    assert any(k.startswith("resampler.") for k in params)


def test_cli_trains_resumes_and_exports_the_adapters(tmp_path):
    cfg = _write_run(tmp_path)
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("unet_trained_parameters: new",
                             f"unet_trained_parameters: lora\n  lora_rank: {RANK}"))
    run = lambda *a: cli.main(["--config", cfg, "--device", "cpu", *a])
    full = run("--log_dir", os.fspath(tmp_path / "full"), "--max_train_steps", "2")
    adapters = [k for k in full.params if "lora_" in k]
    assert len(adapters) == 2 * 4 * 2 * 4
    assert all(k.startswith("unet.") for k in full.params if "lora_" in k or "_ip" in k)
    run("--log_dir", os.fspath(tmp_path / "cut"), "--max_train_steps", "1")
    resumed = run("--log_dir", os.fspath(tmp_path / "cut"), "--max_train_steps", "2",
                  "--resume")
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k
    export_weights(os.fspath(tmp_path / "w.pt"), full.params)
    exported = load_weights(os.fspath(tmp_path / "w.pt"))
    assert all(torch.equal(exported[k], full.params[k].detach()) for k in adapters)
