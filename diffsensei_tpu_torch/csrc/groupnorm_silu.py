"""GroupNorm + SiLU over NHWC memory, in Triton (kernel B3).

Replaces the Pallas TPU kernel ``_gn_silu_kernel``
(``diffsensei_tpu/ops/groupnorm.py:44``, pallas_call at ``:76``), which held a
whole sample in VMEM. On the H100 a sample does not fit one SM (the VAE's last
level is 1024 x 1024 x 128 fp32, 512 MB), so the work is split into passes:

1. ``gn_partial_stats``: one program per (sample, group, chunk of rows) sums
   its chunk, then sums the squared deviations from the chunk's own mean
   (two passes over the chunk; the second mostly hits L2);
2. ``gn_combine``: one program per (sample, group) merges the chunk partials
   with Chan's parallel formula into the mean and 1/sqrt(var + eps);
3. ``gn_apply``: normalize, affine and SiLU, one read and one write of x.

All three are bound by memory bandwidth (a few flops per byte); the design
reads x three times (twice in pass 1, partly from L2) and writes it once. The
TPU kernel's one-pass E[x^2] - E[x]^2 is not used: it loses precision over the
4M elements of a VAE group. Statistics are fp32 for bf16 and fp32 inputs.

This file imports ``triton`` at the top and is loaded only on the card
(``diffsensei_tpu_torch/ops/_build.py::triton_module``).
"""

import triton
import triton.language as tl


@triton.jit
def gn_partial_stats(x_ptr, cnt_ptr, mean_ptr, m2_ptr, HW, C, CG, G,
                     rows_per_chunk, num_chunks,
                     BLOCK_HW: tl.constexpr, BLOCK_CG: tl.constexpr):
    bg = tl.program_id(0)
    chunk = tl.program_id(1)
    b = bg // G
    g = bg % G
    base = x_ptr + b.to(tl.int64) * HW * C + g * CG
    rows = tl.arange(0, BLOCK_HW)
    cols = tl.arange(0, BLOCK_CG)
    col_ok = cols < CG
    row0 = chunk * rows_per_chunk
    row_end = tl.minimum(row0 + rows_per_chunk, HW)

    acc = tl.zeros([BLOCK_HW, BLOCK_CG], dtype=tl.float32)
    for start in range(row0, row_end, BLOCK_HW):
        r = start + rows
        mask = (r < row_end)[:, None] & col_ok[None, :]
        offs = r[:, None].to(tl.int64) * C + cols[None, :]
        acc += tl.load(base + offs, mask=mask, other=0.0).to(tl.float32)
    count = ((row_end - row0) * CG).to(tl.float32)
    mean = tl.sum(tl.sum(acc, axis=1), axis=0) / count

    acc2 = tl.zeros([BLOCK_HW, BLOCK_CG], dtype=tl.float32)
    for start in range(row0, row_end, BLOCK_HW):
        r = start + rows
        mask = (r < row_end)[:, None] & col_ok[None, :]
        offs = r[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(base + offs, mask=mask, other=0.0).to(tl.float32)
        dev = tl.where(mask, x - mean, 0.0)
        acc2 += dev * dev
    m2 = tl.sum(tl.sum(acc2, axis=1), axis=0)

    idx = bg * num_chunks + chunk
    tl.store(cnt_ptr + idx, count)
    tl.store(mean_ptr + idx, mean)
    tl.store(m2_ptr + idx, m2)


@triton.jit
def gn_combine(cnt_ptr, mean_ptr, m2_ptr, gmean_ptr, grstd_ptr, num_chunks, eps,
               BLOCK: tl.constexpr):
    bg = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    ok = offs < num_chunks
    n = tl.load(cnt_ptr + bg * num_chunks + offs, mask=ok, other=0.0)
    mu = tl.load(mean_ptr + bg * num_chunks + offs, mask=ok, other=0.0)
    m2 = tl.load(m2_ptr + bg * num_chunks + offs, mask=ok, other=0.0)
    total = tl.sum(n, axis=0)
    mean = tl.sum(n * mu, axis=0) / total
    d = mu - mean
    var = (tl.sum(m2, axis=0) + tl.sum(n * d * d, axis=0)) / total
    tl.store(gmean_ptr + bg, mean)
    tl.store(grstd_ptr + bg, 1.0 / tl.sqrt(var + eps))


@triton.jit
def gn_apply(x_ptr, y_ptr, w_ptr, b_ptr, gmean_ptr, grstd_ptr, HW, C, CG, G,
             n_row_blocks, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    b = pid // n_row_blocks
    rb = pid % n_row_blocks
    rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    mask = (rows < HW)[:, None] & col_ok[None, :]
    grp = b * G + cols // CG
    mean = tl.load(gmean_ptr + grp, mask=col_ok, other=0.0)
    rstd = tl.load(grstd_ptr + grp, mask=col_ok, other=0.0)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    bb = tl.load(b_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    offs = b.to(tl.int64) * HW * C + rows[:, None].to(tl.int64) * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = (x - mean[None, :]) * rstd[None, :] * w[None, :] + bb[None, :]
    y = y * tl.sigmoid(y)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
