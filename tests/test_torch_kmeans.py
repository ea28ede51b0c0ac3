"""K6 and the k-means codebook: the port against the JAX package.

Inputs are made with numpy from a seed, f32 on the CPU.  `kmeans_argmin_plain`
must equal the JAX Pallas `kmeans_argmin` (interpret mode) exactly, at the
contract shapes of tests/test_pallas.py:119-131; `EuclideanCodebook`'s
quantize / __call__ must equal the JAX class's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from latent_diffusion_speech_tpu.ops.pallas.kmeans import kmeans_argmin as j_kmeans_argmin
from latent_diffusion_speech_tpu.quantize.codebook import EuclideanCodebook as JEuclideanCodebook
from latent_diffusion_speech_tpu.quantize.kmeans import save_codebook as j_save_codebook
from latent_diffusion_speech_tpu_torch.ops.kernels import kmeans as k6
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook
from latent_diffusion_speech_tpu_torch.quantize.kmeans import load_codebook


@pytest.mark.parametrize("n,k,d", [(300, 700, 32), (256, 512, 64)])
def test_k6_plain_matches_pallas_kernel(rng, n, k, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = j_kmeans_argmin(jnp.asarray(x), jnp.asarray(cb), block_n=128, block_k=256)
    got = k6.kmeans_argmin_plain(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_k6_ties_go_to_the_lowest_index():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    x = torch.tensor([[1.0, 1.0], [0.0, 2.0], [3.0, 0.0]])
    assert k6.kmeans_argmin_plain(x, cb).tolist() == [0, 1, 0]


def test_k6_wrapper_uses_plain_only_for_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    before = k6.launches
    assert torch.equal(k6.kmeans_argmin(x, cb), k6.kmeans_argmin_plain(x, cb))
    assert k6.launches == before
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        k6.kmeans_argmin(meta, meta)


def test_split_codes_covers_the_codebook_in_whole_tiles():
    # the trainer's call: 4128 rows against 4096 codes on a 132-SM card
    assert k6.split_codes(4128, 4096, 132) == (8, 512)
    for n, k, sms in [(1, 1, 132), (64, 65, 132), (100_000, 4096, 132), (300, 700, 8)]:
        splits, per = k6.split_codes(n, k, sms)
        assert per % k6.BLOCK_CODES == 0 and splits * per >= k > (splits - 1) * per


@pytest.mark.parametrize("shape", [(7, 16), (2, 5, 16)])
def test_codebook_matches_jax(rng, shape):
    cb = rng.standard_normal((50, 16)).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    ref = JEuclideanCodebook(cb)
    got = EuclideanCodebook(cb, device="cpu")
    ids = got.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref.quantize(jnp.asarray(x))))
    snapped = got(torch.from_numpy(x).requires_grad_())
    assert snapped.shape == shape and snapped.grad_fn is None
    np.testing.assert_array_equal(snapped.numpy(), np.asarray(ref(jnp.asarray(x))))


def test_load_codebook_npz_and_pt(tmp_path, rng):
    cb = rng.standard_normal((6, 4)).astype(np.float32)
    j_save_codebook(tmp_path / "cb.npz", cb)
    np.testing.assert_array_equal(load_codebook(tmp_path / "cb.npz"), cb)
    torch.save({"cluster_centers_": torch.from_numpy(cb)}, tmp_path / "cb.pt")
    np.testing.assert_array_equal(load_codebook(tmp_path / "cb.pt"), cb)
    torch.save({"other": 1}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="unrecognized"):
        load_codebook(tmp_path / "bad.pt")
