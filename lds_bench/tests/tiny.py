"""Small versions of the benchmark's configurations and traffic for CPU tests:
the same layouts and paths at widths a test run holds.  `size="tiny"` for
the paths alone; `size="small"` keeps the vocoder's whole geometry and a
quarter of the UNet's widths, where the control's precision shows as it
does at the shipped widths."""

from lds_bench import manifest

SIZES = {
    "tiny": dict(input_channel=32, codebook_size=16, n_spk=5, block_out_channels=[16, 24, 32, 32], n_heads=2,
                 n_hidden=16, out_dims=8),
    "small": dict(input_channel=320, codebook_size=64, n_spk=5, block_out_channels=[64, 96, 128, 128], n_heads=8,
                  n_hidden=64, out_dims=32),
}
VOCODERS = {
    "tiny": dict(inter_channels=8, upsample_initial_channel=16, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8]),
    "small": dict(inter_channels=32, upsample_initial_channel=64),
}


def config(name: str, dtype: str = "float32", size: str = "tiny") -> dict:
    cfg = manifest.config(name)
    cfg.update(SIZES[size], dtype=dtype)
    cfg["vocoder"] = dict(cfg["vocoder"], **VOCODERS[size])
    return cfg


def traffic(name: str) -> dict:
    t = manifest.traffic(name)
    t["batch"] = min(t["batch"], 4)
    t["lengths"] = dict(t["lengths"], median_frames=40, min_frames=16, max_frames=100)
    t["trace_calls"] = 2
    return t
