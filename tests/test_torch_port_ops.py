"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both implementations. Where the
JAX function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it. The CUDA tests (marked ``gpu``) hold each kernel
against its plain twin on the card and live in ``test_torch_port_kernels.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffsensei_tpu.core import buckets as jbuckets
from diffsensei_tpu.core import config as jconfig
from diffsensei_tpu.ops import flash_attention as jfa
from diffsensei_tpu.ops import groupnorm as jgn
from diffsensei_tpu.ops import masked_ip as jmip
from diffsensei_tpu.ops.attention import attention_ref as j_attention_ref

from diffsensei_tpu_torch.core import buckets as tbuckets
from diffsensei_tpu_torch.core import config as tconfig
from diffsensei_tpu_torch.ops import attention as tatt
from diffsensei_tpu_torch.ops import flash_attention as tfa
from diffsensei_tpu_torch.ops import groupnorm as tgn
from diffsensei_tpu_torch.ops import masked_ip as tmip

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# copied configs and bucket tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,ctor,args", [
    ("MangaConfig", None, ()),
    ("UNetConfig", "sdxl", ()), ("UNetConfig", "tiny", ()),
    ("VAEConfig", "sdxl", ()), ("VAEConfig", "tiny", ()),
    ("TextEncoderConfig", "clip_l", ()), ("TextEncoderConfig", "clip_bigg", ()),
    ("TextEncoderConfig", "tiny", (16,)),
    ("VisionEncoderConfig", "clip_vit_h", ()),
    ("VisionEncoderConfig", "magi_vitmae", ()), ("VisionEncoderConfig", "tiny", ()),
    ("ResamplerConfig", "diffsensei", ()), ("ResamplerConfig", "tiny", ()),
    ("LlamaConfig", "seed_x_13b", ()), ("AgentConfig", "tiny", ()),
    ("PipelineConfig", None, ()),
])
def test_copied_configs_equal_jax(name, ctor, args):
    make = lambda mod: (getattr(getattr(mod, name), ctor)(*args) if ctor
                        else getattr(mod, name)())
    assert dataclasses.asdict(make(tconfig)) == dataclasses.asdict(make(jconfig))
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]


def test_copied_buckets_equal_jax():
    assert tbuckets.SIZE_BUCKETS == jbuckets.SIZE_BUCKETS
    assert tbuckets.all_bucket_shapes() == jbuckets.all_bucket_shapes()
    for h in range(64, 2200, 72):
        for w in range(64, 2200, 88):
            assert tbuckets.get_bucket_size(h, w) == jbuckets.get_bucket_size(h, w)


# ---------------------------------------------------------------------------
# masked-IP conditioning: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,ratio", [(4096, 1.0), (4032, 96 / 168), (1008, 0.57),
                                       (240, 1.5), (91, 7 / 13)])
def test_seq_len_to_hw_equals_jax(seq, ratio):
    assert tmip.seq_len_to_hw(seq, ratio) == jmip.seq_len_to_hw(seq, ratio)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 11), (12, 21)])
def test_ip_attention_bias_equals_jax(h, w):
    rng = np.random.default_rng(h * w)
    lo = rng.uniform(0, 0.6, size=(3, 4, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.1, 0.5, size=(3, 4, 2))],
                         -1).astype(np.float32)             # [x1, y1, x2, y2]
    box[0] = 0.0                                     # an all-zero CFG uncond row
    box[1, 0] = [0.0, 0.0, 1.0, 0.5]                 # edges on grid points
    want = np.asarray(jmip.build_ip_attention_bias(jnp.asarray(box), h, w, 3, 2))
    got = tmip.build_ip_attention_bias(_t(box), h, w, 3, 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_dialog_rasterize_equals_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 13, 6)).astype(np.float32)
    emb = rng.normal(size=(6,)).astype(np.float32)
    boxes = np.array([[[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.9, 0.5], [0, 0, 0, 0]],
                      [[0.0, 0.0, 1.0, 1.0], [0.5, 0.5, 0.55, 0.52],
                       [0.2, 0.3, 0.2, 0.9]]], np.float32)
    want = np.asarray(jmip.rasterize_dialog_embedding(jnp.asarray(x), jnp.asarray(boxes),
                                                      jnp.asarray(emb)))
    got = tmip.rasterize_dialog_embedding(_t(x), _t(boxes), _t(emb)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# attention: plain twin vs the JAX oracle and the Pallas kernel (interpret)
# ---------------------------------------------------------------------------
def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


@pytest.mark.parametrize("causal,with_bias", [(False, False), (False, True), (True, False)])
def test_attention_ref_matches_jax(causal, with_bias):
    q, k, v = _qkv(1, 2, 3, 40, 40, 16)
    bias = None
    if with_bias:
        bias = np.where(np.random.default_rng(2).uniform(size=(2, 1, 40, 40)) > 0.3,
                        0.0, -10000.0).astype(np.float32)
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      None if bias is None else jnp.asarray(bias),
                                      causal=causal))
    got = tatt.multi_head_attention(_t(q), _t(k), _t(v),
                                    None if bias is None else _t(bias), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk,causal,with_bias", [
    (256, 256, False, False),
    (200, 320, False, False),    # ragged q and k tails
    (256, 200, False, True),     # broadcast bias, ragged k tail
    (256, 256, True, False),
])
def test_flash_plain_matches_pallas_kernel(sq, sk, causal, with_bias):
    q, k, v = _qkv(3, 2, 2, sq, sk, 64)
    bias = None
    if with_bias:
        bias = np.random.default_rng(4).choice(
            [0.0, -10000.0], size=(2, 1, sq, sk)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                None if bias is None else jnp.asarray(bias),
                                causal, 64 ** -0.5, 128, 128)
    o, lse = tfa.flash_attention(_t(q), _t(k), _t(v), None if bias is None else _t(bias),
                                 causal=causal)
    assert o.shape == (2, 2, sq, 64) and lse.shape == (2, 2, sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], rtol=1e-5, atol=1e-5)


def test_dispatcher_keeps_cpu_on_plain_math():
    q = torch.zeros(1, 1, 2048, 64, dtype=torch.bfloat16)
    assert not tatt.uses_flash(q, q)
    before = tfa.launches
    tatt.multi_head_attention(q, q, q)
    assert tfa.launches == before


def test_flash_rejects_other_devices():
    q = torch.zeros(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# GroupNorm + SiLU: plain twin vs the Pallas kernel (interpret)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,w,c,g,eps", [(2, 6, 10, 16, 4, 1e-5), (1, 5, 7, 24, 8, 1e-6)])
def test_groupnorm_silu_plain_matches_pallas_kernel(b, h, w, c, g, eps):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(b, h, w, c)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgn._fused(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), g, eps))
    got = tgn.groupnorm_silu(_t(x), _t(scale), _t(bias), g, eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_groupnorm_silu_plain_keeps_bf16():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 8)).astype(np.float32)).bfloat16()
    out = tgn.groupnorm_silu(x, torch.ones(8), torch.zeros(8), 2)
    want = jgn.groupnorm_silu_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  jnp.ones(8), jnp.zeros(8), 2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# the port imports no JAX
# ---------------------------------------------------------------------------
def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, diffsensei_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "[importlib.import_module(n) for n in names]\n"
            "assert len(names) > 20, names\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'diffsensei_tpu.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
