"""Seconds of audio delivered to host memory in the window, over the window's
seconds (the whole window: from the first call's start to the last one's end)."""


def read(run):
    return sum(c.audio_s for c in run.served) / run.window_s
