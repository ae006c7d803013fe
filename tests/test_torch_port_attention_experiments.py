"""B7 and B8, the attention experiments of ``tools/``, against the JAX
scripts' Pallas kernels, on the CPU.

``tools/bench_attention_chunked.py`` (B7, ``chunked_attention``) and
``tools/bench_attention_single.py`` (B8, ``single_pass_attention``) are
loaded by path and run in interpret mode, as the JAX package's tests run its
kernels; the port's entry points run their plain twins on the CPU. The same
numpy-seeded inputs go to both, fp32 within 1e-6 and bf16 within 4e-3 (one
bf16 ulp of an output in [0.5, 1), where p rounds to bf16 a step apart). The
kernels themselves are held against the twins on the card in
``test_torch_port_kernels.py``.
"""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffsensei_tpu_torch.ops import chunked_attention as tca
from diffsensei_tpu_torch.ops import single_pass_attention as tsp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-6, "bfloat16": 4e-3}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_chunked():
    return _script("bench_attention_chunked")


@pytest.fixture(scope="module")
def jax_single():
    return _script("bench_attention_single")


def _inputs(seed, sq, kv, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(1, 2, s, 64)).astype(np.float32) for s in (sq, kv, kv))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    return (jq, jk, jv), (tq, tk, tv)


def _max_err(got, want):
    return (got.float() - torch.from_numpy(np.array(want, np.float32))).abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,kv,block_q,block_k,chunk", [
    (256, 256, 128, 128, 64),    # two k blocks, two chunks a block
    (256, 256, 128, 128, 128),   # chunk == block_k
    (128, 256, 128, 128, 64),    # sq != kv
])
def test_chunked_matches_jax(jax_chunked, dtype, sq, kv, block_q, block_k, chunk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq + kv + chunk, sq, kv, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_chunked.chunked_attention(jq, jk, jv, block_q=block_q, block_k=block_k,
                                             chunk=chunk)
    got = tca.chunked_attention(tq, tk, tv, block_q=block_q, block_k=block_k, chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, tca.chunked_attention_ref(tq, tk, tv, block_q, block_k, chunk))
    assert _max_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("sq,kv,block_q,block_k,chunk", [
    (256, 256, 96, 128, 64),     # sq % block_q
    (256, 256, 128, 96, 32),     # kv % block_k
    (256, 256, 128, 128, 96),    # block_k % chunk
])
def test_chunked_refuses_what_jax_asserts(jax_chunked, sq, kv, block_q, block_k, chunk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, sq, kv, "float32")
    with pytest.raises(AssertionError):
        jax_chunked.chunked_attention(jq, jk, jv, block_q=block_q, block_k=block_k,
                                      chunk=chunk)
    for fn in (tca.chunked_attention, tca.chunked_attention_ref):
        with pytest.raises(ValueError, match="must divide"):
            fn(tq, tk, tv, block_q=block_q, block_k=block_k, chunk=chunk)


def test_chunked_clamps_as_jax():
    """Blocks and chunk larger than the sequences clamp to them: one update
    over all keys, the same bits as an explicit chunk of kv."""
    _, (tq, tk, tv) = _inputs(1, 128, 192, "float32")
    assert tca.effective_chunk(tq, tk) == 192
    assert torch.equal(tca.chunked_attention(tq, tk, tv),
                       tca.chunked_attention(tq, tk, tv, block_k=192, chunk=192))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,kv,block_q", [
    (256, 256, 128),    # two q blocks
    (256, 384, 64),     # sq != kv, four q blocks
])
def test_single_pass_matches_jax(jax_single, dtype, sq, kv, block_q):
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq + kv + block_q, sq, kv, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_single.single_pass_attention(jq, jk, jv, block_q=block_q)
    got = tsp.single_pass_attention(tq, tk, tv, block_q=block_q)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, tsp.single_pass_attention_ref(tq, tk, tv, block_q))
    assert _max_err(got, want) <= TOL[dtype]


def test_single_pass_refuses_dropped_rows():
    """Where block_q does not divide Sq the JAX grid (Sq // block_q) leaves
    the last rows unwritten; the port refuses, twin and entry alike. A
    block_q beyond Sq clamps to it."""
    _, (tq, tk, tv) = _inputs(2, 256, 256, "float32")
    for fn in (tsp.single_pass_attention, tsp.single_pass_attention_ref):
        with pytest.raises(ValueError, match="last 64 rows unwritten"):
            fn(tq, tk, tv, block_q=96)
    assert tsp.effective_block_q(tq, 512) == 256
    assert torch.equal(tsp.single_pass_attention(tq, tk, tv, block_q=512),
                       tsp.single_pass_attention(tq, tk, tv, block_q=256))


def test_single_pass_twin_by_blocks_is_exact():
    """The twin holds one q block's scores at a time: its rows do not depend
    on the block size (each row's softmax is over all keys)."""
    _, (tq, tk, tv) = _inputs(3, 256, 320, "float32")
    whole = tsp.single_pass_attention_ref(tq, tk, tv, block_q=256)
    torch.testing.assert_close(tsp.single_pass_attention_ref(tq, tk, tv, block_q=32), whole,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("tool", ["torch_bench_attention_chunked",
                                  "torch_bench_attention_single"])
def test_tools_need_the_card(tool):
    """The ported tools import the port alone and refuse to run without a
    CUDA device, printing no result."""
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import runpy, sys; sys.argv = ['{tool}']\n"
         f"try:\n    runpy.run_path('tools/{tool}.py', run_name='__main__')\n"
         f"finally:\n    assert 'jax' not in sys.modules, 'the tool imported jax'"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "imported jax" not in proc.stderr
    assert proc.stdout.strip() == ""
