from latent_diffusion_speech_tpu_torch.infer.server import TTSServer  # noqa: F401
from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline  # noqa: F401
