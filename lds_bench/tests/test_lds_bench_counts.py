"""The operation and byte counts against a count by hand at a tiny shape."""

import pytest

from lds_bench import counts


def tiny_cfg():
    return {"block_out_channels": [4, 8], "n_layers": 1, "n_heads": 2, "n_hidden": 2, "out_dims": 2,
            "input_channel": 3, "dtype": "bfloat16", "k_step_max": 1000, "infer_speedup": 50,
            "vocoder": {"inter_channels": 2, "upsample_initial_channel": 4, "upsample_rates": [2],
                        "upsample_kernel_sizes": [4], "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]]}}


def by_hand_unet(B, T, time_mlp=True):
    """Multiply-adds a frame, block by block: levels of 4 channels at T
    (with attention) and 8 at T/2; the input is 2 + 2 = 4 channels, E = 16;
    a transformer at c channels is 22 c^2 (proj_in, q k v out twice, the
    GEGLU's c -> 8c, 4c -> c, proj_out)."""
    at_T = (4 * 4 * 3                        # conv_in
            + 2 * 4 * 4 * 3                  # down.0.res.0 (4 -> 4)
            + 22 * 16                        # down.0.attn.0
            + 8 * 8 * 3                      # up.0.upsample (output at T)
            + 12 * 4 * 3 + 4 * 4 * 3 + 12 * 4  # up.1.res.0 (8 + 4 skip -> 4)
            + 8 * 4 * 3 + 4 * 4 * 3 + 8 * 4    # up.1.res.1 (4 + 4 skip -> 4)
            + 2 * 22 * 16                    # up.1.attn.0, .1
            + 4 * 2 * 3)                     # conv_out
    at_half = (4 * 4 * 3                     # down.0.downsample (output at T/2)
               + 4 * 8 * 3 + 8 * 8 * 3 + 4 * 8  # down.1.res.0 (4 -> 8)
               + 2 * 2 * 8 * 8 * 3           # mid.res.0, .1
               + 22 * 64                     # mid.attn
               + 16 * 8 * 3 + 8 * 8 * 3 + 16 * 8  # up.0.res.0 (8 + 8 skip -> 8)
               + 12 * 8 * 3 + 8 * 8 * 3 + 12 * 8)  # up.0.res.1 (8 + 4 skip -> 8)
    attn = 2 * 4 * T * T * 4 * 3 + 2 * 4 * (T // 2) ** 2 * 8  # three 4-channel transformers, one 8-channel
    # time MLP 4 -> 16 -> 16; each resnet's projection E -> 2 x its output width
    time = 4 * 16 + 16 * 16 + (8 + 16 + 16 + 16 + 16 + 16 + 8 + 8) * 16 if time_mlp else 0
    return B * (2 * (at_T * T + at_half * T // 2) + attn + 2 * time)


@pytest.mark.parametrize("B,T", [(1, 8), (3, 16)])
def test_unet_flops_by_hand(B, T):
    cfg = tiny_cfg()
    assert counts.unet_flops(cfg, B, T) == by_hand_unet(B, T)
    assert counts.unet_flops(cfg, B, T, time_mlp=False) == by_hand_unet(B, T, time_mlp=False)


def test_vocoder_flops_by_hand():
    # conv_pre 2 -> 4 (k7) at T, up 4 -> 2 (k4) from T inputs, one ResBlock1 at 2T:
    # conv1 and conv2 2 -> 2 (k3), conv_post 2 -> 1 (k7) at 2T
    T = 10
    by_hand = 2 * (2 * 4 * 7 * T + 4 * 2 * 4 * T + 2 * (2 * 2 * 3) * 2 * T + 2 * 7 * 2 * T)
    assert counts.vocoder_flops(tiny_cfg()["vocoder"], 1, T) == by_hand


def test_attention_calls_and_bound():
    cfg = tiny_cfg()
    assert counts.attention_calls(cfg, 2, 16) == [(2, 16, 2, 2)] * 2 + [(2, 8, 2, 4)] * 2 + [(2, 16, 2, 2)] * 4
    peak = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    B, T, H, D = 2, 16, 2, 2
    assert counts.attention_bound_s([(B, T, H, D)], "bfloat16", peak) == pytest.approx(2 * H * D * 4 * B * T / 1e9)


def test_unet_fwd_bytes_by_hand():
    cfg = tiny_cfg()
    # every leaf but the time MLP and the time projections' weights and biases (bf16 products, f32 norms),
    # the scale/shift rows, x in and eps out
    got = counts.unet_fwd_bytes(cfg, 8)
    assert got > 0 and counts.unet_fwd_bytes(cfg, 16) - got == 8 * (4 + 2) * 2


def test_bound_picks_the_larger():
    peak = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    assert counts.bound_s(1e9, 1.0, peak) == (1.0, "bytes")
    assert counts.bound_s(1.0, 2e12, peak) == (2.0, "operations")
