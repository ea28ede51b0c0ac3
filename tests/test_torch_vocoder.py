"""The port's HiFi-VAEGAN generator against the JAX package.

TINY geometry of tests/test_e2e.py, and a second geometry with ResBlock2,
k % u != 0 and an odd k - u in its transposed convs; parameters move over with
`convert.generator_from_jax`; latents from numpy; f32 on the CPU; wav held
at atol 2e-5 (tests/test_vaegan.py's torch parity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu_torch.convert import generator_from_jax
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder

GEOMETRIES = {
    "tiny": dict(sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,),
                 resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 2),
                 upsample_initial_channel=16, upsample_kernel_sizes=(8, 4)),
    "resblock2_odd_kernel": dict(sampling_rate=8000, inter_channels=4, resblock="2",
                                 resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
                                 upsample_rates=(3, 2), upsample_initial_channel=8,
                                 upsample_kernel_sizes=(7, 5)),  # k - u odd: 2T - 1 samples
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_generator_matches(rng, name):
    geo = GEOMETRIES[name]
    codec = HifiVAEGAN.random_init(JVAEGANConfig(**geo))
    voc = Vocoder("hifi-vaegan", VAEGANConfig(**geo),
                  state_dict=generator_from_jax(jax.tree_util.tree_map(np.asarray, codec.generator_params)),
                  device="cpu")
    z = rng.standard_normal((2, 10, geo["inter_channels"])).astype(np.float32)
    ref = np.asarray(codec.decode(jnp.asarray(z)))
    got = voc.infer(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape
    if name == "tiny":
        assert got.shape == (2, 10 * voc.vocoder_hop_size)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_vocoder_facade():
    voc = Vocoder("hifi-vaegan", device="cpu")
    assert (voc.vocoder_sample_rate, voc.vocoder_hop_size, voc.dimension) == (44100, 512, 256)
    with pytest.raises(ValueError, match="Unknown vocoder"):
        Vocoder("nsf-hifigan", device="cpu")
