"""The frozen work counts reproduce the figures they were frozen at, and
the Mamba2 model module counts its served requests' work."""

from __future__ import annotations

import pytest

from portbench import harness, work


def test_ssd_least_flops_at_the_kernel_tables_shapes():
    # B=8, S=512: mamba2 (H=80, P=64, N=128) and zamba2 (H=112, N=64)
    assert work.ssd_least_flops(8, 512, 80, 64, 128) == 10_769_924_096
    assert work.ssd_least_flops(8, 512, 112, 64, 64) == 7_568_097_280


def test_flash_bytes_bound_at_zamba2s_prefill_shape():
    nbytes, flops = work.attention_work(8, 32, 32, 512, 112, 2, True, None)
    assert work.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0351,
                                                             abs=5e-5)
    assert nbytes / work.PEAK_BYTES_PER_S > flops / work.PEAK_BF16_FLOPS


def mamba2():
    cell = harness.load_cell("mamba2-2.7b.decode_chat")
    return cell.reference, cell.config["model"]


def test_matmul_weights_are_the_models_less_vectors_and_embedding():
    """The matrix products counted per token, with the padded embedding
    and every per-channel vector added back, are the model's 2,702,968,320
    parameters."""
    ref, m = mamba2()
    d_inner, h, p, n = ref.ssm_dims(m)
    per_layer_vectors = (m["conv_width"] * (d_inner + 2 * n)   # conv taps
                         + (d_inner + 2 * n) + 3 * h + d_inner + m["d_model"])
    counted = m["n_layers"] * (ref.matmul_params(m) + per_layer_vectors)
    padded_vocab = -(-m["vocab"] // 256) * 256
    assert counted + padded_vocab * m["d_model"] + m["d_model"] \
        == 2_702_968_320


def test_request_flops_counts_each_position_once():
    ref, m = mamba2()
    assert ref.request_flops(m, 1, 0) == ref.token_flops(m) \
        + ref.head_flops(m)
    # a prompt of 3 and 2 returned tokens: 5 positions fed, 3 heads
    assert ref.request_flops(m, 3, 2) == (5 * ref.token_flops(m)
                                          + 3 * ref.head_flops(m))


def test_the_ssd_shape_is_one_launch_a_layer_at_the_published_widths():
    ref, m = mamba2()
    assert ref.ssd_shape(m) == (64, 80, 64, 128)
