"""PyTorch / CUDA port of latent_diffusion_speech_tpu: the TTS serve path
(RoFormer AR decode -> 20-step DPM-Solver++ UNet -> HiFi-VAEGAN) and the
diffusion training path (`cli/train_diffusion.py` -> `train/diffusion_trainer.py`).

Module paths mirror the JAX package (`models/lm/roformer.py`,
`models/diffusion/unet1d.py`, ...).  The hand-written Hopper kernels live in
`csrc/` and their wrappers in `ops/kernels/` (the counterpart of
`ops/pallas/`); each wrapper runs its plain PyTorch version for CPU tensors
and its CUDA kernel for CUDA tensors.  Nothing here imports JAX or the JAX
package: the modules it needs from there (the text frontend, the config,
the host data path) are copies.
"""

__version__ = "0.1.0"
