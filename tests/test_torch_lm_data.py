"""The LM's data path in the port against the JAX package.

* `TextDataset` items, `item_lengths` and its `.lengths_cache.npz` sidecar
  (keyed as JAX keys it: either package reads the other's), and
  `collate_text_batch`, identical to JAX's;
* the `DataLoader`'s index batches identical to the JAX loader's with
  `length_sorted` on and off, over two epochs and across a `skip_batches`
  resume;
* two spawn worker processes give the threaded batches, the epoch reaching
  them, and a worker that dies fails the epoch (BrokenProcessPool);
* stages 15 and 16 write files identical to JAX's on the same EN labels.
Exact equality throughout; every corpus is written under `tmp_path`.
"""

import os
from concurrent.futures.process import BrokenProcessPool
from functools import partial

import numpy as np
import pytest

from latent_diffusion_speech_tpu.cli.preprocess_text import merge_labels as j_merge_labels
from latent_diffusion_speech_tpu.cli.preprocess_tts import process_tts as j_process_tts
from latent_diffusion_speech_tpu.data.lm_dataset import TextDataset as JTextDataset
from latent_diffusion_speech_tpu.data.lm_dataset import collate_text_batch as j_collate_text_batch
from latent_diffusion_speech_tpu.data.loader import DataLoader as JDataLoader
from latent_diffusion_speech_tpu_torch import config
from latent_diffusion_speech_tpu_torch.cli import preprocess_text, preprocess_tts
from latent_diffusion_speech_tpu_torch.cli.preprocess_text import merge_labels
from latent_diffusion_speech_tpu_torch.cli.preprocess_tts import process_tts
from latent_diffusion_speech_tpu_torch.data.lm_dataset import TextDataset, collate_text_batch
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader

BOS, EOS, PHONE_PAD, PAD = 4096, 4097, 111, 4098


@pytest.fixture
def lm_dir(tmp_path, rng):
    """3 speakers x 8 utterances in the stages' formats: `utt/` object
    tuples (stage 16) and int32 token ids (stage 19), 20-300 tokens."""
    root = tmp_path / "lm"
    for s, spk in enumerate(("a", "b", "c")):
        (root / "utt" / spk).mkdir(parents=True)
        (root / "semantic_token" / spk).mkdir(parents=True)
        for i in range(8):
            n_ph = 10 + (i * 7 + s) % 30
            utt = np.empty(4, object)
            utt[0] = rng.integers(1, 50, n_ph).astype(np.int64)
            utt[1] = rng.integers(0, 5, n_ph).astype(np.int64)
            utt[2] = np.zeros(n_ph, np.int64)
            utt[3] = np.ones(n_ph, np.int64)
            np.save(root / "utt" / spk / f"u{i}.wav.npy", utt, allow_pickle=True)
            n_sem = 20 + (i * 37 + 11 * s) % 280
            np.save(root / "semantic_token" / spk / f"u{i}.wav.npy", rng.integers(0, 4096, n_sem).astype(np.int32))
    return root


def _collate(items, collate=collate_text_batch):
    return collate(items, phone_pad=PHONE_PAD, semantic_pad=PAD)


def _equal(a: dict, b: dict, what=""):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("kw", [dict(n_spk=4), dict(n_spk=1, cache=True),
                                dict(n_spk=4, process_index=1, process_count=2)])
def test_text_dataset_matches_jax(lm_dir, kw):
    mine, theirs = TextDataset(lm_dir, BOS, EOS, **kw), JTextDataset(lm_dir, BOS, EOS, **kw)
    assert mine.paths == theirs.paths and mine.spk_map == theirs.spk_map and len(mine) == len(theirs)
    for i in range(len(mine)):
        _equal(mine[i], theirs[i], f"item {i}")
    np.testing.assert_array_equal(mine.item_lengths(), theirs.item_lengths())


def test_item_lengths_sidecar_is_keyed_as_jax_keys_it(lm_dir):
    sidecar = lm_dir / "semantic_token" / ".lengths_cache.npz"
    lens = TextDataset(lm_dir, BOS, EOS).item_lengths()
    assert [lens[i] for i in range(len(lens))] == [len(TextDataset(lm_dir, BOS, EOS)[i]["semantic"])
                                                  for i in range(len(lens))]
    mine = dict(np.load(sidecar))
    sidecar.unlink()
    np.testing.assert_array_equal(JTextDataset(lm_dir, BOS, EOS).item_lengths(), lens)
    theirs = dict(np.load(sidecar))
    assert str(mine["key"]) == str(theirs["key"])
    np.testing.assert_array_equal(mine["lens"], theirs["lens"])
    # a sidecar with the same key is read, not recomputed (JAX's, marked)
    np.savez(sidecar, key=theirs["key"], lens=theirs["lens"] + 1000)
    np.testing.assert_array_equal(TextDataset(lm_dir, BOS, EOS).item_lengths(), lens + 1000)
    # a corpus that changed size invalidates it
    np.save(lm_dir / "semantic_token" / "a" / "u0.wav.npy", np.arange(5, dtype=np.int32))
    assert TextDataset(lm_dir, BOS, EOS).item_lengths()[0] == 7


@pytest.mark.parametrize("kw", [dict(), dict(pad_multiple=8), dict(max_phone_len=64, max_semantic_len=320)])
def test_collate_text_batch_matches_jax(lm_dir, kw):
    ds = TextDataset(lm_dir, BOS, EOS, n_spk=4)
    items = [ds[i] for i in (0, 5, 9, 17)]
    got = collate_text_batch(items, PHONE_PAD, PAD, **kw)
    _equal(got, j_collate_text_batch(items, PHONE_PAD, PAD, **kw))
    assert (got["labels"] == -100).sum() == (got["attention_mask"] == 0).sum()


class _Sized:
    """Index items with the lengths `item_lengths` reports."""

    def __init__(self, n, seed=0):
        self.lens = np.random.default_rng(seed).integers(5, 400, n)

    def __len__(self):
        return len(self.lens)

    def __getitem__(self, i):
        return {"i": np.array([i])}

    def item_lengths(self):
        return self.lens


@pytest.mark.parametrize("n,batch,drop_last,length_sorted,pool_factor,shuffle", [
    (40, 4, True, False, 50, True),
    (40, 4, True, True, 3, True),
    (43, 4, False, True, 2, True),
    (43, 5, False, True, 50, False),
])
def test_loader_index_batches_match_jax(n, batch, drop_last, length_sorted, pool_factor, shuffle):
    def stream(loader, skip=0):
        out = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            loader.skip_batches(skip if epoch == 0 else 0)
            out.append([b["i"][:, 0].tolist() for b in loader])
        return out

    kw = dict(batch_size=batch, seed=7, drop_last=drop_last, length_sorted=length_sorted,
              pool_factor=pool_factor, shuffle=shuffle)
    want = stream(JDataLoader(_Sized(n), **kw))
    assert stream(DataLoader(_Sized(n), **kw)) == want
    # a mid-epoch resume replays the rest of the epoch, then whole epochs
    assert stream(DataLoader(_Sized(n), **kw), skip=3) == [want[0][3:], want[1]]


def test_length_sorted_needs_item_lengths():
    class Plain:
        def __len__(self):
            return 8

    with pytest.raises(ValueError, match="item_lengths"):
        DataLoader(Plain(), batch_size=2, length_sorted=True)


class _DiesInWorker(_Sized):
    """Unpickling it in a worker ends the worker's process."""

    def __reduce__(self):
        return os._exit, (3,)


def test_worker_processes_give_the_threaded_batches(lm_dir):
    """Two spawn workers over the corpus, length-sorted: every batch of two
    epochs equal to the threaded loader's, the second epoch from a
    mid-epoch resume; a worker that dies raises, it never hangs."""
    ds = TextDataset(lm_dir, BOS, EOS, n_spk=4)
    # the collate as stage 21 passes it: a partial of the port's function,
    # so a worker imports the port's data modules only
    collate = partial(collate_text_batch, phone_pad=PHONE_PAD, semantic_pad=PAD)
    kw = dict(batch_size=4, collate=collate, seed=5, length_sorted=True, pool_factor=2)
    procs, threads = DataLoader(ds, num_workers=2, **kw), DataLoader(ds, **kw)
    try:
        for epoch, skip in ((0, 0), (1, 2)):
            for loader in (procs, threads):
                loader.set_epoch(epoch)
                loader.skip_batches(skip)
            got, want = list(procs), list(threads)
            assert len(got) == len(want) == len(ds) // 4 - skip
            for g, w in zip(got, want):
                _equal(g, w, f"epoch {epoch}")
    finally:
        procs.close()
    dead = DataLoader(_DiesInWorker(8), batch_size=2, num_workers=1)
    with pytest.raises(BrokenProcessPool):
        list(dead)
    assert dead._proc_pool is None  # the failed epoch closed the pool


EN_LABELS = {
    "spk0": ["Hello world, this is a test.", "The quick brown fox jumps over the lazy dog."],
    "spk1": ["We will start the meeting soon!", "Is the weather fine today?", "Bring it back, please."],
}


def _label_layout(root):
    for spk, texts in EN_LABELS.items():
        (root / "audio" / spk).mkdir(parents=True, exist_ok=True)
        for n, text in enumerate(texts):
            (root / "audio" / spk / f"{n}.wav").write_bytes(b"")
            (root / "audio" / spk / f"{n}.txt").write_text(f"  {text}\nsecond line\n", encoding="utf-8")
    return root


def test_stages_15_and_16_write_jax_files(tmp_path):
    mine, theirs = _label_layout(tmp_path / "port"), _label_layout(tmp_path / "jax")
    assert merge_labels(mine) == j_merge_labels(theirs) == 5
    for spk in EN_LABELS:
        assert (mine / "audio" / spk / "utt_text.txt").read_bytes() == \
            (theirs / "audio" / spk / "utt_text.txt").read_bytes()
    assert list(process_tts(mine, language="EN")) == list(j_process_tts(theirs, language="EN"))
    for spk, texts in EN_LABELS.items():
        for n in range(len(texts)):
            a = np.load(mine / "utt" / spk / f"{n}.wav.npy", allow_pickle=True)
            b = np.load(theirs / "utt" / spk / f"{n}.wav.npy", allow_pickle=True)
            assert a.dtype == b.dtype == object and a.shape == b.shape
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
                assert np.asarray(x).dtype == np.asarray(y).dtype
    # 'text' mode reaches the WordPiece tokenizer in both packages: without a
    # vocab.txt both raise FileNotFoundError naming LDS_BERT_VOCAB
    # (tests/test_torch_bert.py writes one and compares the files)
    for fn, root in ((process_tts, mine), (j_process_tts, theirs)):
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("LDS_BERT_VOCAB", raising=False)
            mp.chdir(tmp_path)
            with pytest.raises(FileNotFoundError, match="LDS_BERT_VOCAB"):
                list(fn(root, mode="text", language="EN"))


def test_stage_mains_read_the_config(tmp_path):
    root = _label_layout(tmp_path / "train")
    cfg = config.Config()
    cfg.data.train_path, cfg.data.valid_path = str(root), str(_label_layout(tmp_path / "val"))
    config.save_config(cfg, tmp_path / "config.yaml")
    preprocess_text.main(["-c", str(tmp_path / "config.yaml")])
    assert (tmp_path / "val" / "audio" / "spk1" / "utt_text.txt").exists()
    preprocess_tts.main(["-c", str(tmp_path / "config.yaml"), "--language", "EN"])
    assert sorted(p.name for p in (root / "utt").rglob("*.npy")) == ["0.wav.npy", "0.wav.npy", "1.wav.npy",
                                                                     "1.wav.npy", "2.wav.npy"]
    assert not (tmp_path / "val" / "utt").exists()  # stage 16 prepares the train path, as JAX's
