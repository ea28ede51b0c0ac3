"""The native batched read and device-side collation against the JAX package.

* the host `fast_batch` equals JAX's bit for bit, latent noise included;
* the raw batch (`device_collate=True`) finished by the trainer's
  `finalize` with `only_mean` equals JAX's host `fast_batch` exactly, and
  its units window keeps one static shape across batches;
* `transfer_dtype="bfloat16"`: the native converting read and the
  non-native cast both equal JAX's ml_dtypes bits;
* with `only_mean`, one `train_step` on a raw batch equals one on the host
  batch (loss and every gradient within 1e-6); a sampled latent is held to
  its statistics (eps = (z - m) / exp(logs) ~ N(0, 1)), not to its bits;
* the loader yields JAX's batches in thread mode and in process mode, and
  `cli/train_diffusion.py::build` trains with `device_collate`.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.data import DataLoader as JDataLoader
from latent_diffusion_speech_tpu.data import DiffusionDataset as JDiffusionDataset
from latent_diffusion_speech_tpu_torch.cli.train_diffusion import build
from latent_diffusion_speech_tpu_torch.config import Config
from latent_diffusion_speech_tpu_torch.data.diffusion_dataset import DiffusionDataset
from latent_diffusion_speech_tpu_torch.data.loader import DataLoader
from latent_diffusion_speech_tpu_torch.data.native_loader import NativeNpyReader
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer, step_generator

MEL_DIM, UNIT_DIM = 4, 8
TINY_MODEL = Unit2MelConfig(input_channel=UNIT_DIM, n_spk=4, out_dims=MEL_DIM, n_hidden=8,
                            block_out_channels=(8, 8), n_heads=2, timesteps=20, k_step=20)


@pytest.fixture
def root(tmp_path, rng):
    """Two speakers, three files each, units at 0.58x the mel rate, and one
    file too short to crop (the fast path redraws its index)."""
    root = tmp_path / "train"
    for spk in ("1", "2"):
        for n in range(3):
            T = 120 + 10 * n if (spk, n) != ("2", 2) else 40
            (root / "audio" / spk).mkdir(parents=True, exist_ok=True)
            (root / "audio" / spk / f"{n}.wav").write_bytes(b"")
            for kind, arr in [("mel", rng.standard_normal((T, 2 * MEL_DIM)).astype(np.float32)),
                              ("units", rng.standard_normal((int(T * 0.58), UNIT_DIM)).astype(np.float32))]:
                (root / kind / spk).mkdir(parents=True, exist_ok=True)
                np.save(root / kind / spk / f"{n}.wav.npy", arr)
    return root


def _pair(root, **kw):
    kw.setdefault("only_mean", True)
    kw.setdefault("clamp", -1.0)
    args = dict(waveform_sec=1.0, hop_size=2, sample_rate=100, n_spk=4)  # 50-frame crops
    return JDiffusionDataset(root, **args, **kw), DiffusionDataset(root, **args, **kw)


def _cfg(tmp_path, only_mean=True, clamp=-1.0) -> Config:
    cfg = Config()
    cfg.common.n_spk = 4
    cfg.common.vocoder.only_mean = only_mean
    cfg.common.vocoder.clamp = clamp
    cfg.diffusion.train.expdir = str(tmp_path / "exp")
    cfg.diffusion.train.interval_log = cfg.diffusion.train.interval_val = 10_000
    return cfg


def _trainer(tmp_path, **kw) -> DiffusionTrainer:
    return DiffusionTrainer(_cfg(tmp_path, **kw), model_cfg=TINY_MODEL, device="cpu")


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if y.dtype == ml_dtypes.bfloat16:
            y = y.view(np.uint16)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


IDX = [0, 5, 1, 4, 2, 3]


@pytest.mark.parametrize("only_mean,clamp", [(False, 0.5), (True, -1.0)])
def test_host_fast_batch_equals_jax_bitwise(root, only_mean, clamp):
    j, p = _pair(root, only_mean=only_mean, clamp=clamp)
    for epoch in (0, 3):
        j.set_epoch(epoch)
        p.set_epoch(epoch)
        _same(p.fast_batch(IDX), j.fast_batch(IDX))


@pytest.mark.parametrize("transfer_dtype", [None, "bfloat16"])
def test_raw_batch_equals_jax_raw_batch(root, transfer_dtype):
    j, p = _pair(root, device_collate=True, transfer_dtype=transfer_dtype)
    raw = p.fast_batch(IDX)
    _same(raw, j.fast_batch(IDX))
    assert raw["units_raw"].dtype == (np.uint16 if transfer_dtype else np.float32)
    assert raw["mel_stats"].dtype == np.float32 and raw["unit_idx"].dtype == np.int32


class _PlainReader:
    """The native reader without its converting read: the dataset casts."""

    def __init__(self):
        self._reader = NativeNpyReader()

    def probe(self, path):
        return self._reader.probe(path)

    def read_batch(self, *args, **kw):
        return self._reader.read_batch(*args, **kw)


def test_bf16_without_the_converting_read_equals_jax(root):
    j, p = _pair(root, device_collate=True, transfer_dtype="bfloat16")
    _same(p.fast_batch(IDX, reader=_PlainReader()), j.fast_batch(IDX))


def test_raw_finalized_on_the_device_equals_jax_host_batch(root, tmp_path):
    j, _ = _pair(root)
    _, p = _pair(root, device_collate=True)
    host = j.fast_batch(IDX)
    tr = _trainer(tmp_path)
    units, mel = tr.finalize(tr.device_put_batch(p.fast_batch(IDX)), step_generator(0, 0, tr.device))
    np.testing.assert_array_equal(units.numpy(), host["units"])
    np.testing.assert_array_equal(mel.numpy(), host["mel"])


def test_units_window_keeps_one_shape(root):
    _, p = _pair(root, device_collate=True)
    shapes = set()
    for e in range(4):
        p.set_epoch(e)
        shapes.add(p.fast_batch(IDX[: 2 + e])["units_raw"].shape[1:])
    assert shapes == {(p._u_fixed, UNIT_DIM)}


def test_sampled_latent_has_the_stats_of_z(root, tmp_path):
    _, p = _pair(root, device_collate=True, only_mean=False, clamp=-1.0)
    raw = p.fast_batch(IDX)
    tr = _trainer(tmp_path, only_mean=False)
    batch = tr.device_put_batch(raw)
    _, z = tr.finalize(batch, step_generator(0, 0, tr.device))
    m, logs = batch["mel_stats"].chunk(2, dim=-1)
    eps = ((z - m) / logs.exp()).numpy().ravel()
    assert eps.size == 6 * 50 * MEL_DIM
    assert abs(eps.mean()) < 4 / eps.size ** 0.5 and abs(eps.std() - 1) < 0.06
    _, z2 = tr.finalize(batch, step_generator(0, 0, tr.device))
    torch.testing.assert_close(z, z2, rtol=0, atol=0)  # a pure function of (seed, step)


def test_train_step_on_raw_equals_host(root, tmp_path):
    j, _ = _pair(root)
    _, p = _pair(root, device_collate=True, transfer_dtype="bfloat16")
    host = j.fast_batch(IDX)
    raw = p.fast_batch(IDX)
    # bf16 units round: compare with the host batch's units rounded the same way
    host["units"] = np.asarray(host["units"].astype(ml_dtypes.bfloat16), np.float32)
    grads = []
    for batch in (host, raw):
        tr = _trainer(tmp_path)
        out = tr.train_step(tr.device_put_batch(batch), step_generator(0, 0, tr.device))
        grads.append((float(out["loss"]), float(out["grad_norm"]), [p.grad.clone() for p in tr._params]))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=0, abs=1e-6)
    assert grads[0][1] == pytest.approx(grads[1][1], rel=1e-6)
    for a, b in zip(grads[0][2], grads[1][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_yields_jax_batches(root, num_workers):
    j, p = _pair(root, device_collate=True, transfer_dtype="bfloat16")
    ref = list(JDataLoader(j, batch_size=2, seed=5))
    loader = DataLoader(p, batch_size=2, seed=5, num_workers=num_workers)
    try:
        got = list(loader)
    finally:
        loader.close()
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        _same(a, b)


def test_a_failed_read_falls_back_to_items(root):
    j, p = _pair(root)
    (root / "units" / "1" / "1.wav.npy").write_bytes(b"not an npy")  # probes fine before, fails on read
    p._probe_all(NativeNpyReader())
    p._probed["1/1.wav"] = p._probed["1/0.wav"]
    loader = DataLoader(p, batch_size=6, shuffle=False)
    with pytest.raises(OSError):
        p.fast_batch(list(range(6)))
    batch = next(iter(loader))
    assert not loader._fast and batch["units"].shape == (6, 50, UNIT_DIM)


def test_cli_build_trains_on_device_collated_batches(root, tmp_path):
    cfg = _cfg(tmp_path)
    cfg.data.train_path, cfg.data.block_size, cfg.data.sampling_rate = str(root), 2, 100
    cfg.data.encoder = "hubert_soft"  # 256-d units
    for f in (root / "units").rglob("*.npy"):
        np.save(f, np.random.default_rng(1).standard_normal((np.load(f).shape[0], 256)).astype(np.float32))
    tcfg = cfg.diffusion.train
    tcfg.batch_size, tcfg.device_collate, tcfg.transfer_dtype = 2, True, "bfloat16"
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.out_dims, m.timesteps, m.k_step_max = (8, 8), 2, 8, MEL_DIM, 20, 20
    trainer, loader = build(cfg, device="cpu")
    assert loader.dataset.device_collate and loader.dataset.transfer_dtype == "bfloat16"
    assert loader.device_put == trainer.pin_batch
    batch = next(iter(loader))
    assert batch["units_raw"].dtype == torch.bfloat16 and batch["units_raw"].shape[-1] == 256
    trainer.train(loader, max_steps=2)
    assert trainer.step == 2
