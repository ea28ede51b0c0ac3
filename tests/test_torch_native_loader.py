"""The port's native npy batch reader (`data/native_loader.py`).

Reads are held to numpy bit for bit; the converting bf16 read to
ml_dtypes' cast (used in this test only) and to the JAX package's reader,
specials and NaN payloads included (the JAX package is imported inside
that test only, so the spawn children below start without it).  The build is serialised across
processes: two spawn processes building into one empty build directory at
once both load the library, and a failed build raises with g++'s stderr.
"""

import multiprocessing as mp
import os

import ml_dtypes
import numpy as np
import pytest

from latent_diffusion_speech_tpu_torch.data import native_loader
from latent_diffusion_speech_tpu_torch.data.diffusion_dataset import bf16_bits
from latent_diffusion_speech_tpu_torch.data.native_loader import NativeNpyReader


@pytest.fixture(scope="module")
def reader():
    return NativeNpyReader(num_threads=4)


def test_probe(tmp_path, reader, rng):
    np.save(tmp_path / "a.npy", rng.standard_normal((100, 8)).astype(np.float32))
    assert reader.probe(tmp_path / "a.npy") == (100, 32, np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int64])
def test_read_matches_numpy(tmp_path, reader, rng, dtype):
    files, ref = [], []
    for i in range(6):
        arr = (rng.standard_normal((50 + i, 4)) * 100).astype(dtype)
        np.save(tmp_path / f"{i}.npy", arr)
        files.append(tmp_path / f"{i}.npy")
        ref.append(arr[i : i + 20])
    assert reader.probe(files[0])[2] == dtype
    np.testing.assert_array_equal(reader.read_batch(files, range(6), 20, (4,), dtype=dtype), np.stack(ref))


def test_3d_rows(tmp_path, reader, rng):
    arr = rng.standard_normal((30, 2, 5)).astype(np.float32)
    np.save(tmp_path / "b.npy", arr)
    np.testing.assert_array_equal(reader.read_batch([tmp_path / "b.npy"], [3], 10, (2, 5))[0], arr[3:13])


@pytest.mark.parametrize("case", ["out_of_range", "missing", "row_bytes"])
def test_bad_reads_raise_oserror_naming_the_file(tmp_path, reader, rng, case):
    np.save(tmp_path / "c.npy", rng.standard_normal((10, 4)).astype(np.float32))
    good = tmp_path / "c.npy"
    path, start, count, inner = {
        "out_of_range": (good, 5, 10, (4,)),
        "missing": (tmp_path / "nope.npy", 0, 1, (4,)),
        "row_bytes": (good, 0, 2, (8,)),
    }[case]
    with pytest.raises(OSError, match=path.name):
        reader.read_batch([good, path], [0, start], count, inner)
    if case == "missing":
        with pytest.raises(OSError):
            reader.probe(path)


def test_bf16_read_matches_ml_dtypes_and_jax(tmp_path, reader, rng):
    files, ref = [], []
    for i in range(4):
        arr = (rng.standard_normal((60 + i, 16)) * 10).astype(np.float32)
        arr[0, :8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 3.0]
        arr[1, 0] = np.float32(1.0 + 2**-8)  # a tie: to even
        arr[1, 1] = np.float32(1.0 + 3 * 2**-9)  # rounds up
        arr[1, 2:4] = np.array([0x7F800001, 0xFF923456], np.uint32).view(np.float32)  # NaN payloads
        np.save(tmp_path / f"bf_{i}.npy", arr)
        files.append(tmp_path / f"bf_{i}.npy")
        ref.append(arr[i : i + 40])
    from latent_diffusion_speech_tpu.data.native_loader import NativeNpyReader as JNativeNpyReader

    out = reader.read_batch_bf16(files, range(4), 40, (16,))
    assert out.dtype == np.uint16
    want = np.stack(ref).astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, JNativeNpyReader().read_batch_bf16(files, range(4), 40, (16,)).view(np.uint16))
    np.testing.assert_array_equal(bf16_bits(np.stack(ref)), want)  # the dataset's non-native cast


def test_bf16_read_rejects_non_f32(tmp_path, reader, rng):
    np.save(tmp_path / "i4.npy", rng.integers(0, 9, (10, 4)).astype(np.int32))
    with pytest.raises(OSError):
        reader.read_batch_bf16([tmp_path / "i4.npy"], [0], 2, (4,))


def _build_in_child(build_dir, barrier, out):
    os.environ["LDS_TORCH_BUILD_DIR"] = build_dir
    barrier.wait()
    try:
        r = NativeNpyReader(num_threads=1)
        out.put((str(native_loader.library_path()), r.probe(os.path.join(build_dir, "..", "x.npy"))[0]))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        out.put(repr(e))


def test_two_processes_build_one_empty_build_dir_at_once(tmp_path):
    np.save(tmp_path / "x.npy", np.zeros((7, 2), np.float32))
    build = tmp_path / "build"
    ctx = mp.get_context("spawn")
    barrier, out = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=_build_in_child, args=(str(build), barrier, out)) for _ in range(2)]
    for p in procs:
        p.start()
    results = [out.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive() and p.exitcode == 0
    assert results[0] == results[1] and results[0][1] == 7, results
    assert [p.name for p in build.iterdir() if p.suffix == ".so"] == [os.path.basename(results[0][0])]
    assert not list(build.glob("*.tmp"))


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "npy_batch.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SRC", bad)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("LDS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        NativeNpyReader()
    assert not list((tmp_path / "build").glob("*.so*"))
