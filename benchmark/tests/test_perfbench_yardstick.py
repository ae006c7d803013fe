"""The yardstick's arithmetic against shapes worked by hand."""

import pytest

from benchmark import yardstick as Y


def test_b1_cost_at_the_unet_level_1_shape():
    # (2, 10, 4096, 64): 4 B H S^2 D = 85.90 GFLOP; q, k, v, o bf16 and the lse
    flops, nbytes = Y.flash_fwd_cost((2, 10, 4096, 64), (2, 10, 4096, 64))
    assert flops == 4 * 2 * 10 * 4096 * 4096 * 64 == 85_899_345_920
    assert nbytes == 2 * 4 * (2 * 10 * 4096 * 64) + 4 * 2 * 10 * 4096
    assert Y.least_s(flops, nbytes) == pytest.approx(flops / 989e12)


def test_b1_cost_counts_a_stored_bias_once():
    base = Y.flash_fwd_cost((1, 2, 128, 64), (1, 2, 256, 64))
    with_bias = Y.flash_fwd_cost((1, 2, 128, 64), (1, 2, 256, 64), (1, 1, 128, 256))
    assert with_bias[1] - base[1] == 4 * 128 * 256
    assert with_bias[0] == base[0]


def test_b2_b4_cost():
    # the backward without stored probabilities: 10 B H Sq Sk D; reads q, k, v,
    # o, dO and the lse, writes dQ, dK, dV
    flops, nbytes = Y.flash_bwd_cost((1, 10, 4096, 64), (1, 10, 4096, 64))
    assert flops == 10 * 10 * 4096 * 4096 * 64
    n = 10 * 4096 * 64
    assert nbytes == 2 * 5 * n + 4 * 10 * 4096 + 2 * 3 * n


def test_b5_cost():
    # (2, 10, 4096, 64) over 77 text and 80 IP keys, fp32 bias [2, 1, 4096, 80]
    flops, nbytes = Y.dual_cost((2, 10, 4096, 64), (2, 10, 77, 64), (2, 10, 80, 64),
                                (2, 1, 4096, 80))
    assert flops == 4 * 2 * 10 * 4096 * 64 * 157
    q = 2 * 10 * 4096 * 64
    assert nbytes == 2 * (3 * q + 2 * 2 * 10 * 157 * 64) + 4 * 2 * 4096 * 80
    # bound by bytes at this shape, as the kernel table says of B5
    assert nbytes / Y.HBM_BYTES_PER_S > flops / Y.PEAK_FLOPS["bfloat16"]


def test_least_time_takes_the_larger_bound_and_the_dtype_peak():
    assert Y.least_s(989e12, 0) == pytest.approx(1.0)
    assert Y.least_s(67e12, 0, "float32") == pytest.approx(1.0)
    assert Y.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert Y.least_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_roofline_share_is_none_without_launches():
    assert Y.roofline_pct([], 1.0) is None
    assert Y.roofline_pct([0.5], 0.0) is None
    assert Y.roofline_pct([0.25, 0.25], 1.0) == pytest.approx(50.0)


def test_spread_uses_python_quartiles():
    values = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    # statistics.quantiles (exclusive): Q1 1.75, Q3 5.25, median 3.5
    assert Y.spread(values) == pytest.approx((5.25 - 1.75) / 3.5)


@pytest.mark.parametrize("name, key", [
    ("void (anonymous namespace)::hop::fwd_kernel<128>(CUtensorMap, CUtensorMap)", "b1"),
    ("void (anonymous namespace)::flash_fwd_kernel<64>(__nv_bfloat16 const*)", "b1"),
    ("void (anonymous namespace)::hop::bwd_dq_kernel<64>(CUtensorMap)", "b2"),
    ("void (anonymous namespace)::hop::bwd_dkv_kernel<64>(CUtensorMap)", "b4"),
    ("void (anonymous namespace)::dual_cross_attention_kernel<64>(__nv_bfloat16 const*)", "b5"),
    ("_ZN12_GLOBAL__N_13hop10fwd_kernelILi128EEEv14CUtensorMap_st", "b1"),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>(Flash_fwd_params)", None),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
])
def test_kernel_names(name, key):
    assert Y.kernel_of(name) == key
