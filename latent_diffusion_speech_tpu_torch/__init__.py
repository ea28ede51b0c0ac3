"""PyTorch / CUDA port of latent_diffusion_speech_tpu, first slice: the TTS
serve path (RoFormer AR decode -> 20-step DPM-Solver++ UNet -> HiFi-VAEGAN).

Module paths mirror the JAX package (`models/lm/roformer.py`,
`models/diffusion/unet1d.py`, ...).  The hand-written Hopper kernels live in
`csrc/` and their wrappers in `ops/kernels/` (the counterpart of
`ops/pallas/`); each wrapper runs its plain PyTorch version for CPU tensors
and its CUDA kernel for CUDA tensors.  Nothing here imports JAX: the only
code shared with the JAX package is its framework-free text frontend.
"""

__version__ = "0.1.0"
