"""The port's tiled VAE decode against the JAX package, on the CPU, in fp32.

The tiny VAE's weights cross to the port through ``from_jax.vae``; both
packages decode the same numpy latents. The bound is the decoder parity
test's: atol 5e-4 in fp32.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsensei_tpu.core.config import VAEConfig
from diffsensei_tpu.models.vae import AutoencoderKL as JVAE, tiled_decode as jtiled_decode

from diffsensei_tpu_torch.core.config import VAEConfig as TVAEConfig
from diffsensei_tpu_torch.models.vae import AutoencoderKL as TVAE, tiled_decode
from diffsensei_tpu_torch.pipelines import pipeline as tpipe
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import random_tree

torch.set_num_threads(1)
ATOL = 5e-4


@pytest.fixture(scope="module")
def vaes():
    """(JAX VAE, its params, the port's VAE with the same weights)."""
    cfg = VAEConfig.tiny()
    jm = JVAE(cfg)
    params = random_tree(jm, jnp.zeros((1, 32, 32, 3)), jax.random.key(8), seed=7)
    tm = TVAE(cfg)
    tm.load_decoder_state_dict(from_jax.to_tensors(from_jax.vae(params, cfg)))
    return jm, params, tm.eval()


def test_tiled_decode_matches_jax(vaes):
    jm, params, tm = vaes
    z = np.random.default_rng(11).normal(size=(2, 20, 28, 4)).astype(np.float32)
    with torch.no_grad():
        got = tiled_decode(tm, torch.from_numpy(z), tile=12, overlap=4)
    want = jtiled_decode(jm, params, jnp.asarray(z), tile=12, overlap=4)
    assert got.shape == (2, 20 * 8, 28 * 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_tiling_machinery_is_exact_for_equivariant_decoder(vaes):
    """With a spatially equivariant decoder (pure upsampling), the tiled
    output equals the direct decode: the tile offsets are right and the blend
    weights sum to 1 everywhere."""
    _, _, tm = vaes
    f = tm.config.downscale_factor
    z = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 24, 20, 4)).astype(np.float32))

    def fake_decode(zt):
        up = zt.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
        return up[..., :3] * 2.0 + 0.1

    tiled = tiled_decode(tm, z, tile=12, overlap=4, decode_fn=fake_decode)
    np.testing.assert_allclose(tiled.numpy(), fake_decode(z).numpy(), rtol=1e-5, atol=1e-5)


def test_tiled_small_input_is_the_whole_decode(vaes):
    _, _, tm = vaes
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tiled_decode(tm, z, tile=12, overlap=4), tm.decode(z))


@pytest.mark.parametrize("latent,tiles", [
    ((96, 168), [(96, 96), (96, 96)]),   # the 768x1344 bucket: two tiles
    ((128, 128), [(128, 128)]),          # 1024²: decoded whole
])
def test_pipeline_decode_tiles_a_latent_side_above_128(latent, tiles):
    calls = []

    def stub(zt):
        calls.append(tuple(zt.shape[1:3]))
        return torch.zeros((zt.shape[0], 8 * zt.shape[1], 8 * zt.shape[2], 3))

    vae = types.SimpleNamespace(config=TVAEConfig.sdxl(), decode=stub)
    img = tpipe._decode(vae, torch.zeros((1, *latent, 4)), 0.13025)
    assert calls == tiles
    assert img.shape == (1, 8 * latent[0], 8 * latent[1], 3)
    np.testing.assert_allclose(img.numpy(), 0.5)
