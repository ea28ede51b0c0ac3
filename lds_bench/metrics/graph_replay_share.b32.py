"""`graph_replay_share`'s reading, for the cells that report `audio_s_per_s.b32`."""

from lds_bench import manifest

read = manifest.metric_reader("graph_replay_share").read
