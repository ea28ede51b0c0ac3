"""The benchmark of `latent_diffusion_speech_tpu_torch`, the PyTorch and CUDA
port: units -> waveform through `TTSPipeline.infer` on one NVIDIA H100.

One run of one cell: `python3 -m lds_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the checkout's root.  `BENCHMARK.json`
names the cells; each configuration, traffic mix and metric is a file of
its own here (`configs/<name>.json`, `traffic/<name>.json`,
`metrics/<name>.py`), found by name.  The yardstick lives here too: the
plain reference (`reference/`), the operation and byte counts and the
published peaks (`counts.py`), and the comparison that decides `correct`
(`check.py`).  Nothing here imports JAX or the JAX package.
"""
