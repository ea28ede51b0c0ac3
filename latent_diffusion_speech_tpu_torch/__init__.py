"""PyTorch / CUDA port of latent_diffusion_speech_tpu: the TTS serve path
(RoFormer AR decode -> 20-step DPM-Solver++ UNet -> HiFi-VAEGAN; the entry
points `cli/infer_tts.py`, `cli/serve.py`, `infer/load.py`), SVC long-audio
inference (`cli/infer_svc.py`), the diffusion training path
(`cli/train_diffusion.py` -> `train/diffusion_trainer.py`), the LM
training path for the RoFormer and the Llama (`cli/train_lm.py` ->
`train/lm_trainer.py`, whose checkpoints the serve entry points load), the
text-mode front end (`text/wordpiece.py`, `models/bert.py`,
`text/bert.py`), and the preprocessing stages 10
(`cli/preprocess_unit.py`), 15 (`cli/preprocess_text.py`), 16
(`cli/preprocess_tts.py`) and 19 (`cli/preprocess_token.py`).

Module paths mirror the JAX package (`models/lm/roformer.py`,
`models/diffusion/unet1d.py`, ...).  The hand-written Hopper kernels live in
`csrc/` and their wrappers in `ops/kernels/` (the counterpart of
`ops/pallas/`); each wrapper runs its plain PyTorch version for CPU tensors
and its CUDA kernel for CUDA tensors.  Nothing here imports JAX or the JAX
package: the modules it needs from there (the text frontend, the config,
the host data path) are copies.
"""

__version__ = "0.1.0"
