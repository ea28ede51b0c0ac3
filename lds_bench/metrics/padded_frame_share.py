"""% of the frames the denoiser ran that no caller asked for: 100 x (1 -
`tts.frames_requested` / `diffusion.frames_denoised`), the program's
counters over the traced calls (length-bucket and downsample-grid
padding)."""

from lds_bench import program_spans


def read(run):
    program = program_spans.of(run)
    return None if program is None else program.padded_frame_share()
