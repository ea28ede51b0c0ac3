"""Host ms of the synchronised `Unit2MelSystem.infer` span (condition,
weight packing, the sampler over the denoiser) per second of audio, over
the traced calls."""


def read(run):
    return None if run.trace is None else run.trace.stage_ms_per_audio_s("diffusion")
