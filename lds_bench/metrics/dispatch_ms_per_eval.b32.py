"""`dispatch_ms_per_eval`'s reading, for the cells that report `audio_s_per_s.b32`."""

from lds_bench import manifest

read = manifest.metric_reader("dispatch_ms_per_eval").read
