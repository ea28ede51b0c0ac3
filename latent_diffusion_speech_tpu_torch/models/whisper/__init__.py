from latent_diffusion_speech_tpu_torch.models.whisper.model import (  # noqa: F401
    WhisperDims,
    WhisperEncoder,
)
