"""Host ms of the synchronised `Vocoder.infer` span (the HiFi-VAEGAN
generator) per second of audio, over the traced calls."""


def read(run):
    return None if run.trace is None else run.trace.stage_ms_per_audio_s("vocoder")
