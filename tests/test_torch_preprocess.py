"""The port's data stages 00-02, 11, 17 and 18 against the JAX package's.

* stages 00-02 (`cli/prepare_audio.py`) on two copies of one tree: the
  same files deleted, renamed and moved, with the same seed;
* stage 11 (`process_mels`) with both packages' vocoders on one reference
  `encoder.pth` / `decoder.pth` pair: the same files, `mel/` and `aug_mel/`
  within the codec tolerance (the gains are the same numpy draws);
* `kmeans_fit` from a given `init` against JAX's after 4 epochs at
  N = 3 x batch + 17 (the wrap-around of the last batch runs): centroids
  atol 1e-4, inertia within 1e-5 relative (f32 sums of squared distances,
  JAX's through the matmul identity, the port's directly);
* `kmeanspp_init` returns distinct rows of the (subsampled) data, and on
  blobs `kmeans_fit` recovers them and predicts as sklearn does
  (tests/test_quantize.py's spec);
* `save_codebook` -> `load_codebook` in both packages;
* stage 17's `main` against JAX's on the same unit files: both codebooks
  recover the blobs (the k-means++ draws differ: torch's generator
  against `jax.random`), and stage 11's `main` writes what `process_mels`
  writes;
* stage 18's `main` (EN) against JAX's on one validation tree, with the
  same vocoder pair and Whisper checkpoint: mel / aug_mel within the codec
  tolerance, units (bf16 in both, the default) within a relative RMS error
  of 2e-2 (tests/test_torch_units.py's bf16 bound), utt files equal.

Codec tolerance: atol 5e-5, rtol 1e-4 (tests/test_verify_import.py).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.cli import prepare_audio as j_prepare
from latent_diffusion_speech_tpu.cli import preprocess_cluster as j_cluster
from latent_diffusion_speech_tpu.cli import preprocess_val as j_val
from latent_diffusion_speech_tpu.cli.preprocess_mel import process_mels as j_process_mels
from latent_diffusion_speech_tpu.models.vocoder import Vocoder as JVocoder
from latent_diffusion_speech_tpu.quantize import kmeans as j_kmeans
from latent_diffusion_speech_tpu_torch import config
from latent_diffusion_speech_tpu_torch.cli import prepare_audio, preprocess_cluster, preprocess_mel, preprocess_val
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from latent_diffusion_speech_tpu_torch.ops.audio_io import write_wav
from latent_diffusion_speech_tpu_torch.quantize import kmeans
from tests.test_torch_codec import _h, _randomize_weight_norm
from tests.test_torch_units import TINY as WHISPER_TINY
from tests.test_torch_units import _reference_state
from tests.test_vaegan import TINY, TorchEncoder, TorchGenerator

ATOL, RTOL = 5e-5, 1e-4
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config.yaml"
SR = 44100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (the parallel run's workers would
    otherwise spin against each other on every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocoder_dir(tmp_path_factory):
    """A reference `encoder.pth` / `decoder.pth` pair, TINY geometry at 44.1 kHz."""
    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    path = tmp_path_factory.mktemp("hifi-vaegan")
    h = _h(TINY, sampling_rate=SR)
    for name, module in (("encoder", TorchEncoder(TINY)), ("decoder", TorchGenerator(TINY))):
        torch.save({"model": _randomize_weight_norm(module.eval(), rng).state_dict(), "config": h},
                   path / f"{name}.pth")
    return path


def _compare_tree(a: Path, b: Path, sub: str, **tol):
    names = sorted(p.relative_to(a / sub) for p in (a / sub).rglob("*.npy"))
    assert names and names == sorted(p.relative_to(b / sub) for p in (b / sub).rglob("*.npy"))
    for n in names:
        x, y = np.load(a / sub / n, allow_pickle=True), np.load(b / sub / n, allow_pickle=True)
        if tol:
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, n
            np.testing.assert_allclose(x, y, **tol)
        else:
            assert len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y)), n
    return names


def _audio_tree(root: Path, seed: int, layout=(("spkA", (0.3, 0.5)), ("spkB", (0.4,)))):
    rng = np.random.default_rng(seed)
    for spk, secs in layout:
        for i, sec in enumerate(secs):
            path = root / spk / f"u{i}.wav"
            path.parent.mkdir(parents=True, exist_ok=True)
            t = np.arange(int(sec * SR)) / SR
            write_wav(path, (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(t.size)).astype(np.float32),
                      SR)


def _files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


# -- stages 00-02 --------------------------------------------------------------------


def test_stages_00_to_02_move_the_same_files(tmp_path):
    for pkg in ("jax", "port"):
        root = tmp_path / pkg / "train"
        for s, spk in enumerate(("alice", "bob", "carol", "3")):
            (root / spk).mkdir(parents=True)
            for i in range(3 + s):
                write_wav(root / spk / f"{spk}_{i}.wav", np.zeros(800 * (1 + i), np.float32), 8000)
                (root / spk / f"{spk}_{i}.txt").write_text(f"label {i}")
        (root / "bob" / "broken.wav").write_bytes(b"not a wav")
    out = {}
    for pkg, mod in (("jax", j_prepare), ("port", prepare_audio)):
        root, val = tmp_path / pkg / "train", tmp_path / pkg / "val"
        out[pkg] = (mod.drop_long_audio(root, 0.45), mod.renumber_speakers(root),
                    mod.extract_valset(root, val, n_speakers=3, n_files=2, seed=5))
    assert out["port"] == out["jax"] and out["port"][0] > 0 and out["port"][2] == 6
    for sub in ("train", "val"):
        assert _files(tmp_path / "port" / sub) == _files(tmp_path / "jax" / sub)
    assert sorted(p.name for p in (tmp_path / "port" / "train").iterdir()) == ["1", "2", "3", "4"]


def test_prepare_audio_main(tmp_path):
    _audio_tree(tmp_path / "train", 0, (("x", (0.2, 0.6)), ("y", (0.2,))))
    prepare_audio.main([str(tmp_path / "train"), "--max-sec", "0.5", "--renumber", "--valset", str(tmp_path / "val")])
    assert _files(tmp_path / "train") == []
    assert _files(tmp_path / "val") == ["1/u0.wav", "2/u0.wav"]


# -- stage 11 ------------------------------------------------------------------------


def test_stage_11_writes_jax_latents(tmp_path, vocoder_dir):
    for pkg in ("jax", "port"):
        _audio_tree(tmp_path / pkg / "audio", 3)
    ref = dict(j_process_mels(tmp_path / "jax", JVocoder("hifi-vaegan", str(vocoder_dir)), SR))
    got = dict(preprocess_mel.process_mels(tmp_path / "port", Vocoder(device="cpu", ckpt=str(vocoder_dir)), SR))
    assert got == ref and len(got) == 3
    for sub in ("mel", "aug_mel"):
        _compare_tree(tmp_path / "port", tmp_path / "jax", sub, atol=ATOL, rtol=RTOL)
    mel = np.load(tmp_path / "port" / "mel" / "spkA" / "u1.wav.npy")
    aug = np.load(tmp_path / "port" / "aug_mel" / "spkA" / "u1.wav.npy")
    assert mel.shape == (-(-int(0.5 * SR) // 8), 12) and not np.allclose(mel, aug)


# -- k-means -------------------------------------------------------------------------


def _blobs(rng, n_per=200, k=8, d=16, spread=0.05):
    centers = rng.standard_normal((k, d)).astype(np.float32) * 2
    data = np.concatenate([c + spread * rng.standard_normal((n_per, d)).astype(np.float32) for c in centers])
    return data, centers, np.repeat(np.arange(k), n_per)


def test_kmeans_fit_from_an_init_matches_jax(rng):
    batch = 64
    data = rng.standard_normal((3 * batch + 17, 8)).astype(np.float32)
    init = data[rng.choice(len(data), 16, replace=False)]
    want, w_inertia = j_kmeans.kmeans_fit(data, k=16, epochs=4, batch_size=batch, seed=3, init=init)
    got, inertia = kmeans.kmeans_fit(data, k=16, epochs=4, batch_size=batch, seed=3, init=init, device="cpu")
    assert got.shape == (16, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert abs(inertia - w_inertia) <= 1e-5 * w_inertia


def test_assign_update_matches_jax(rng):
    c = rng.standard_normal((16, 8)).astype(np.float32)
    counts = rng.integers(0, 5, 16).astype(np.float32)
    batch = rng.standard_normal((64, 8)).astype(np.float32)
    jc, jn, ji = j_kmeans._assign_update(c, counts, batch)
    pc, pn, pi = kmeans._assign_update(torch.from_numpy(c), torch.from_numpy(counts), torch.from_numpy(batch))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert abs(pi.item() - float(ji)) <= 1e-5 * float(ji)


@pytest.mark.parametrize("sample", [65536, 100])
def test_kmeanspp_init_draws_distinct_rows_of_the_data(rng, sample):
    data = rng.standard_normal((500, 8)).astype(np.float32)
    init = kmeans.kmeanspp_init(data, 32, seed=4, sample=sample, device="cpu").numpy()
    rows = data if sample >= len(data) else data[np.random.default_rng(4).choice(len(data), sample, replace=False)]
    hits = [(np.abs(rows - c).max(axis=1) == 0).nonzero()[0] for c in init]
    assert all(len(h) == 1 for h in hits)
    assert len({int(h[0]) for h in hits}) == 32
    again = kmeans.kmeanspp_init(data, 32, seed=4, sample=sample, device="cpu").numpy()
    np.testing.assert_array_equal(init, again)


def test_kmeans_fit_recovers_blobs(rng):
    data, centers, labels = _blobs(rng)
    cb, _ = kmeans.kmeans_fit(data, k=8, epochs=8, batch_size=256, seed=0, device="cpu")
    d = np.linalg.norm(centers[:, None, :] - cb[None, :, :], axis=-1)
    assert d.min(axis=1).max() < 0.2
    pred = kmeans.kmeans_predict(data, cb).numpy()
    for blob in range(8):
        ids = pred[labels == blob]
        assert (ids == ids[0]).mean() > 0.99


def test_kmeans_fit_predicts_as_sklearn(rng):
    sklearn = pytest.importorskip("sklearn.cluster")
    data, _, _ = _blobs(rng, n_per=50)
    cb, _ = kmeans.kmeans_fit(data, k=8, epochs=4, batch_size=128, device="cpu")
    km = sklearn.KMeans(n_clusters=8, n_init=1)
    km.fit(data[:100])
    km.cluster_centers_ = cb.astype(np.float32)
    km._n_threads = 1
    np.testing.assert_array_equal(kmeans.kmeans_predict(data, cb).numpy(), km.predict(data))


def test_save_codebook_round_trip(tmp_path, rng):
    cb = rng.standard_normal((16, 4)).astype(np.float32)
    kmeans.save_codebook(tmp_path / "sub" / "cb.npz", cb)
    np.testing.assert_array_equal(kmeans.load_codebook(tmp_path / "sub" / "cb.npz"), cb)
    np.testing.assert_array_equal(j_kmeans.load_codebook(tmp_path / "sub" / "cb.npz"), cb)
    kmeans.save_codebook(tmp_path / "bare", cb)  # numpy adds the suffix, as in JAX
    np.testing.assert_array_equal(kmeans.load_codebook(tmp_path / "bare.npz"), cb)


# -- the stage CLIs on a tiny config ----------------------------------------------------------


def _config(tmp_path, vocoder_dir, k=8) -> Path:
    cfg = config.load_config(CONFIG)
    cfg.data.train_path, cfg.data.valid_path = str(tmp_path / "train"), str(tmp_path / "val")
    cfg.common.vocoder.ckpt = str(vocoder_dir)
    cfg.text2semantic.model.semantic_kmeans_num = k
    cfg.text2semantic.model.codebook_path = str(tmp_path / "codebook.npz")
    path = tmp_path / "tiny.yaml"
    config.save_config(cfg, path)
    return path


def _jax_main(module, monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def test_stages_11_and_17_mains(tmp_path, rng, vocoder_dir, monkeypatch):
    data, centers, _ = _blobs(rng, n_per=100)
    for root in ("jax", "port"):
        path = _config(tmp_path / root, vocoder_dir)
        units = tmp_path / root / "train" / "units"
        for i, part in enumerate(np.split(data, 8)):
            (units / f"s{i % 2}").mkdir(parents=True, exist_ok=True)
            np.save(units / f"s{i % 2}" / f"f{i}.wav.npy", part)
    _jax_main(j_cluster, monkeypatch, "-c", str(tmp_path / "jax" / "tiny.yaml"))
    preprocess_cluster.main(["-c", str(tmp_path / "port" / "tiny.yaml"), "--device", "cpu"])
    want, got = (kmeans.load_codebook(tmp_path / root / "codebook.npz") for root in ("jax", "port"))
    assert got.shape == want.shape == (8, 16)
    for cb in (want, got):  # both recover every blob
        assert np.linalg.norm(centers[:, None] - cb[None], axis=-1).min(axis=1).max() < 0.2

    _audio_tree(tmp_path / "port" / "train" / "audio", 5)
    preprocess_mel.main(["-c", str(tmp_path / "port" / "tiny.yaml"), "--device", "cpu"])
    shutil.copytree(tmp_path / "port" / "train" / "audio", tmp_path / "again" / "audio")
    dict(preprocess_mel.process_mels(tmp_path / "again", Vocoder(device="cpu", ckpt=str(vocoder_dir)), SR))
    for sub in ("mel", "aug_mel"):
        _compare_tree(tmp_path / "port" / "train", tmp_path / "again", sub, atol=0, rtol=0)


def test_stage_18_main_matches_jax(tmp_path, vocoder_dir, monkeypatch):
    whisper = tmp_path / "whisper.pt"
    torch.save({"dims": dict(WHISPER_TINY, n_vocab=51866), "model_state_dict": _reference_state(seed=3)}, whisper)
    labels = ["Hello world, this is a test.", "The cat sat on the mat.", "We will meet again soon."]
    for root in ("jax", "port"):
        _config(tmp_path / root, vocoder_dir)
        audio = tmp_path / root / "val" / "audio"
        _audio_tree(audio, 9)
        for spk in ("spkA", "spkB"):
            stems = sorted(p.stem for p in (audio / spk).glob("*.wav"))
            (audio / spk / "utt_text.txt").write_text("".join(f"{s}|{t}\n" for s, t in zip(stems, labels)))
    _jax_main(j_val, monkeypatch, "-c", str(tmp_path / "jax" / "tiny.yaml"), "--ckpt", str(whisper),
              "--language", "EN")
    preprocess_val.main(["-c", str(tmp_path / "port" / "tiny.yaml"), "--ckpt", str(whisper), "--language", "EN",
                         "--device", "cpu"])
    port, jax_root = tmp_path / "port" / "val", tmp_path / "jax" / "val"
    for sub in ("mel", "aug_mel"):
        assert len(_compare_tree(port, jax_root, sub, atol=ATOL, rtol=RTOL)) == 3
    assert len(_compare_tree(port, jax_root, "utt")) == 3
    for name in sorted((port / "units").rglob("*.npy")):
        u, r = np.load(name), np.load(jax_root / "units" / name.relative_to(port / "units"))
        assert u.dtype == np.float32 and u.shape == r.shape and u.shape[1] == WHISPER_TINY["n_audio_state"]
        assert np.sqrt(np.mean((u - r) ** 2) / np.mean(r ** 2)) < 2e-2
    assert not (tmp_path / "port" / "train").exists()
