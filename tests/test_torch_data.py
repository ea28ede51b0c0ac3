"""The port's host data path against the JAX package: the same files, seed
and epoch give the same items (exactly; also for a data-parallel rank's
share of the files), the loader the same batch order, and
`units_forced_alignment` the same frames.
"""

import numpy as np
import pytest

from latent_diffusion_speech_tpu.data.diffusion_dataset import DiffusionDataset as JDiffusionDataset
from latent_diffusion_speech_tpu.data.loader import DataLoader as JDataLoader
from latent_diffusion_speech_tpu.ops.alignment import units_forced_alignment as j_align
from latent_diffusion_speech_tpu_torch.data.diffusion_dataset import DiffusionDataset
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
from latent_diffusion_speech_tpu_torch.ops.alignment import units_forced_alignment


@pytest.fixture
def layout(tmp_path, rng):
    """3 speakers x 3 files; mel stats (T, 8), units (T // 2 + 1, 6); one
    file too short for a 1 s crop."""
    root = tmp_path / "train"
    for spk in ("a", "b", "c"):
        for n in range(3):
            (root / "audio" / spk).mkdir(parents=True, exist_ok=True)
            (root / "audio" / spk / f"{n}.wav").write_bytes(b"")
            T = 30 if (spk, n) == ("b", 1) else 90 + 7 * n
            for kind, arr in [("mel", rng.standard_normal((T, 8))), ("units", rng.standard_normal((T // 2 + 1, 6)))]:
                (root / kind / spk).mkdir(parents=True, exist_ok=True)
                np.save(root / kind / spk / f"{n}.wav.npy", arr.astype(np.float32))
    return root


@pytest.mark.parametrize("kw", [
    dict(),
    dict(only_mean=True, clamp=0.5, units_forced_mode="linear"),
    dict(clamp=0.0, cache=True),
    # a data-parallel rank's share of the files and its own draws
    dict(process_index=1, process_count=2),
    dict(process_index=2, process_count=3, seed=5),
])
def test_dataset_items_match_jax(layout, kw):
    common = dict(waveform_sec=1.0, hop_size=2, sample_rate=100, n_spk=4, **kw)
    mine, theirs = DiffusionDataset(layout, **common), JDiffusionDataset(layout, **common)
    assert mine.paths == theirs.paths and mine.spk_map == theirs.spk_map and len(mine) == len(theirs)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(mine)):
            a, b = mine[i], theirs[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"epoch {epoch} item {i} {key}")
    got, want = mine.batch([0, 1]), theirs.batch([0, 1])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


class _Index:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("n,batch,drop_last", [(12, 3, True), (14, 4, False)])
def test_loader_batch_order_matches_jax(n, batch, drop_last):
    def stream(loader, epochs=2, skip=0):
        out = []
        for e in range(epochs):
            loader.set_epoch(e)
            loader.skip_batches(skip if e == 0 else 0)
            out.append([b["i"][:, 0].tolist() for b in loader])
        return out

    kw = dict(batch_size=batch, shuffle=True, seed=5, drop_last=drop_last)
    want = stream(JDataLoader(_Index(n), **kw))
    assert stream(DataLoader(_Index(n), **kw)) == want
    assert len(DataLoader(_Index(n), **kw)) == len(want[0])
    # a mid-epoch resume replays the tail of the epoch, then whole epochs
    assert stream(DataLoader(_Index(n), **kw), skip=2) == [want[0][2:], want[1]]


def test_threaded_items_equal_serial(layout):
    def stream(threads):
        ds = DiffusionDataset(layout, waveform_sec=1.0, hop_size=2, sample_rate=100, n_spk=4)
        loader = DataLoader(ds, batch_size=2, seed=4, num_threads=threads)
        loader.set_epoch(1)
        out = list(loader)
        loader.close()
        return out

    for a, b in zip(stream(1), stream(4), strict=True):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_loader_fails_the_epoch_on_a_bad_item():
    class Bad(_Index):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable"):
        list(DataLoader(Bad(8), batch_size=2, shuffle=False))
    # stopping early releases the producer; the next epoch starts over
    loader = DataLoader(_Index(8), batch_size=2, shuffle=False)
    assert next(iter(loader))["i"][:, 0].tolist() == [0, 1]
    assert [b["i"][0, 0] for b in loader] == [0, 2, 4, 6]


@pytest.mark.parametrize("mode,kw", [
    ("nearest", dict(n_frames=87)),
    ("linear", dict(n_frames=87)),
    ("left", dict(scale_factor=0.5)),
    ("rfa441to512", dict(audio_len=44100, hop_size=512)),
])
def test_units_forced_alignment_matches_jax(rng, mode, kw):
    for units in (rng.standard_normal((50, 4)).astype(np.float32),
                  rng.standard_normal((2, 37, 3)).astype(np.float32)):
        got = units_forced_alignment(units, mode=mode, **kw)
        np.testing.assert_array_equal(got, np.asarray(j_align(units, mode=mode, **kw)))
    with pytest.raises(ValueError):
        units_forced_alignment(units, mode="cubic", n_frames=3)
