"""The general `UNet1DCondition` over the block zoo against the JAX package.

* The four zoo configurations (between them every down and up block type
  and the three mid blocks), built by both packages'
  `Unit2MelConfig(denoiser="general", ...).general_unet_config()` at small
  widths (32, 32, 64, 64), one layer, heads of dim 8 as at full width; the
  port on attn_impl="pallas" (K5's plain version on the CPU), flax on 'xla'
  (its plain reference); atol 2e-4 / rtol 1e-3 (the general denoiser's
  tolerance, tests/test_torch_unet_general.py).
* Each conditioning input on a two-level UNet at the same tolerance: the
  Fourier time embedding with text_time, `timestep_cond` and the embedding
  activations, every class-embedding type, the encoder states through the
  transformer, added-K/V, K and dual-transformer blocks with
  `encoder_hid_proj`, both masks and both cross-attention norms, and the
  ControlNet and adapter residuals.  The Kandinsky surfaces raise as in JAX.
* One zoo configuration's 20-step DPM-Solver++ sample and waveform through
  `TTSPipeline.infer` at atol/rtol 2e-3 (tests/test_diffusion.py), and
  `Unit2MelSystem.loss` with every gradient under attn_impl="xla" (loss
  rtol 1e-5, gradients atol 1e-5 / rtol 1e-4, tests/test_torch_train.py).
* A reference-named state dict through both packages'
  `block_params_from_torch` gives equal trees, which load back into the port.

Parameters are drawn with numpy over the flax tree's shapes
(`jax.eval_shape` of the init, tests/test_torch_unet_zoo_blocks.py::draw)
and moved over with the converter.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_speech_tpu.models.diffusion import import_torch as j_import
from latent_diffusion_speech_tpu.models.diffusion.unet1d_condition import UNet1DCondition as JUNet
from latent_diffusion_speech_tpu.models.diffusion.unet1d_condition import UNet1DConditionConfig as JConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2Mel as JUnit2Mel
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelConfig as JUnit2MelConfig
from latent_diffusion_speech_tpu.models.diffusion.unit2mel import Unit2MelSystem as JUnit2MelSystem
from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.models.vaegan.codec import HifiVAEGAN
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.convert import _convert
from latent_diffusion_speech_tpu_torch.infer.tts import TTSPipeline
from latent_diffusion_speech_tpu_torch.models.diffusion import import_torch
from latent_diffusion_speech_tpu_torch.models.diffusion.unet1d_condition import UNet1DCondition, UNet1DConditionConfig
from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelConfig, Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.vaegan.config import VAEGANConfig
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from tests.test_torch_unet_zoo_blocks import _to, draw

# the zoo configurations: (down_block_types, up_block_types, mid_block_type)
ZOO = {
    "zoo_attn": (("ResnetDownsampleBlock2D", "AttnDownBlock2D", "SimpleCrossAttnDownBlock2D", "DownBlock2D"),
                 ("UpBlock2D", "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "ResnetUpsampleBlock2D"),
                 "UNetMidBlock2DSimpleCrossAttn"),
    "zoo_skip": (("AttnSkipDownBlock2D", "SkipDownBlock2D", "AttnSkipDownBlock2D", "SkipDownBlock2D"),
                 ("SkipUpBlock2D", "AttnSkipUpBlock2D", "SkipUpBlock2D", "AttnSkipUpBlock2D"), "UNetMidBlock2D"),
    "zoo_encdec": (("DownEncoderBlock2D", "AttnDownEncoderBlock2D", "DownEncoderBlock2D", "AttnDownEncoderBlock2D"),
                   ("AttnUpDecoderBlock2D", "UpDecoderBlock2D", "AttnUpDecoderBlock2D", "UpDecoderBlock2D"),
                   "UNetMidBlock2D"),
    "zoo_k": (("KDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D", "KCrossAttnDownBlock2D"),
              ("KCrossAttnUpBlock2D",) * 3 + ("KUpBlock2D",), None),
}
SMALL = dict(input_channel=12, n_spk=4, out_dims=8, n_hidden=16, block_out_channels=(32, 32, 64, 64), n_layers=1,
             timesteps=100, k_step=100, denoiser="general")
B, T = 2, 16


def _zoo(name, **kw):
    down, up, mid = ZOO[name]
    return dict(SMALL, down_block_types=down, up_block_types=up, mid_block_type=mid, **kw)


def _jsystem(name):
    """The JAX system of a zoo configuration over drawn parameters (its own
    init would compile a whole-model program)."""
    cfg = JUnit2MelConfig(attn_impl="xla", **_zoo(name))
    probe = (jnp.zeros((1, 8, SMALL["input_channel"])), jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 8)))
    shapes = jax.eval_shape(lambda r: JUnit2Mel(cfg).init(r, probe[0], spk_id=probe[1], aug_shift=probe[2]),
                            jax.random.PRNGKey(0))["params"]
    return JUnit2MelSystem(cfg, params=draw(shapes))


def _compare(jcfg, cfg, x, t, context_dim=None, **inputs):
    """The flax model ('xla') and the port ('pallas') from one drawn tree on
    the same inputs: returns (port output, flax output)."""
    args = (jnp.asarray(x), jnp.asarray(t))
    jinputs = _to(inputs, jnp.asarray)
    params = draw(jax.eval_shape(JUNet(jcfg).init, jax.random.PRNGKey(0), *args, **jinputs)["params"])
    jmod = JUNet(jcfg, attn_impl="xla")
    ref = jax.jit(lambda p, x, t, kw: jmod.apply({"params": p}, x, t, **kw))(params, *args, jinputs)
    model = UNet1DCondition(cfg, attn_impl="pallas", context_dim=context_dim)
    model.load_state_dict(_convert(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), **_to(inputs, torch.from_numpy))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_config_matches_jax(name, rng):
    jcfg = JUnit2MelConfig(**_zoo(name)).general_unet_config()
    cfg = Unit2MelConfig(**_zoo(name)).general_unet_config()
    x = rng.standard_normal((B, T, cfg.in_channels)).astype(np.float32)
    got, ref = _compare(jcfg, cfg, x, np.array([3, 711], np.int32))
    assert got.shape == (B, T, SMALL["out_dims"])
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


# the conditioning inputs, each on a two-level UNet: name -> (config, port
# context_dim, inputs made from an rng)
TWO = dict(in_channels=8, out_channels=8, block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
           attention_head_dim=8, cross_attention_dim=20, down_block_types=("DownBlock2D", "AttnDownBlock2D"),
           up_block_types=("AttnUpBlock2D", "UpBlock2D"), mid_block_type="UNetMidBlock2D")
CROSS = dict(down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), mid_block_type="UNetMidBlock2DCrossAttn")


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(rng, n):
    m = (rng.random((B, n)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


CONDITIONING = {
    "fourier_text_time_timestep_cond": (
        dict(time_embedding_type="fourier", addition_embed_type="text_time", addition_time_embed_dim=8,
             projection_class_embeddings_input_dim=34, time_cond_proj_dim=6, time_embedding_act_fn="silu",
             timestep_post_act="mish", center_input_sample=True), None,
        lambda r: dict(timestep_cond=_f(r, B, 6),
                       added_cond_kwargs=dict(text_embeds=_f(r, B, 10), time_ids=_f(r, B, 3)))),
    "class_timestep": (dict(class_embed_type="timestep"), None,
                       lambda r: dict(class_labels=np.array([4, 250], np.int32))),
    "class_timestep_concat": (dict(class_embed_type="timestep", class_embeddings_concat=True), None,
                              lambda r: dict(class_labels=np.array([4, 250], np.int32))),
    "class_identity": (dict(class_embed_type="identity"), None, lambda r: dict(class_labels=_f(r, B, 128))),
    "class_projection": (dict(class_embed_type="projection", projection_class_embeddings_input_dim=12), None,
                         lambda r: dict(class_labels=_f(r, B, 12))),
    "class_simple_projection": (dict(class_embed_type="simple_projection", projection_class_embeddings_input_dim=12),
                                None, lambda r: dict(class_labels=_f(r, B, 12))),
    "class_label_table": (dict(num_class_embeds=5), None, lambda r: dict(class_labels=np.array([0, 3], np.int32))),
    # the JAX model applies the attention mask at full resolution only, so
    # no attention below the top level may take it: no mid block here
    "encoder_states_hid_proj_and_masks": (
        dict(CROSS, mid_block_type=None, encoder_hid_dim_type="text_proj", encoder_hid_dim=12), 12,
        lambda r: dict(encoder_hidden_states=_f(r, B, 5, 12), attention_mask=_mask(r, T),
                       encoder_attention_mask=_mask(r, 5))),
    "encoder_states_added_kv_group_norm": (
        dict(down_block_types=("SimpleCrossAttnDownBlock2D", "ResnetDownsampleBlock2D"),
             up_block_types=("ResnetUpsampleBlock2D", "SimpleCrossAttnUpBlock2D"),
             mid_block_type="UNetMidBlock2DSimpleCrossAttn", cross_attention_dim=32, only_cross_attention=True,
             cross_attention_norm="group_norm", resnet_skip_time_act=True, resnet_out_scale_factor=2.0), 32,
        lambda r: dict(encoder_hidden_states=_f(r, B, 5, 32), encoder_attention_mask=_mask(r, 5))),
    "encoder_states_k_blocks": (
        dict(down_block_types=("KDownBlock2D", "KCrossAttnDownBlock2D"),
             up_block_types=("KCrossAttnUpBlock2D", "KUpBlock2D"), mid_block_type=None, layers_per_block=2), 20,
        lambda r: dict(encoder_hidden_states=_f(r, B, 5, 20), encoder_attention_mask=_mask(r, 5))),
    "encoder_states_dual_transformer": (dict(CROSS, dual_cross_attention=True), 20,
                                        lambda r: dict(encoder_hidden_states=_f(r, B, 334, 20))),
    "controlnet_residuals": (
        dict(CROSS, only_cross_attention=True), None,
        lambda r: dict(down_block_additional_residuals=(_f(r, B, T, 32), _f(r, B, T, 32), _f(r, B, T // 2, 32),
                                                        _f(r, B, T // 2, 64)),
                       mid_block_additional_residual=_f(r, B, T // 2, 64))),
    "adapter_residuals": (
        dict(CROSS, only_cross_attention=True), None,
        lambda r: dict(down_block_additional_residuals=(_f(r, B, T, 32), _f(r, B, T // 2, 64)))),
}


@pytest.mark.parametrize("name", sorted(CONDITIONING))
def test_conditioning_input_matches_jax(name, rng):
    over, context_dim, make = CONDITIONING[name]
    kw = dict(TWO, **over)
    x = rng.standard_normal((B, T, 8)).astype(np.float32)
    got, ref = _compare(JConfig(**kw), UNet1DConditionConfig(**kw), x, np.array([3, 711], np.int32),
                        context_dim=context_dim, **make(rng))
    assert got.shape == (B, T, 8)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


KANDINSKY = [dict(encoder_hid_dim=8, encoder_hid_dim_type="image_proj"),
             dict(encoder_hid_dim=8, encoder_hid_dim_type="text_image_proj"),
             dict(addition_embed_type="text_image"), dict(addition_embed_type="image"),
             dict(addition_embed_type="image_hint")]


@pytest.mark.parametrize("kw", KANDINSKY, ids=lambda kw: str(list(kw.values())[-1]))
def test_kandinsky_surfaces_raise_as_jax(kw):
    with pytest.raises(NotImplementedError) as j_err:
        JConfig(**kw)
    with pytest.raises(NotImplementedError) as err:
        UNet1DConditionConfig(**kw)
    assert str(err.value) == str(j_err.value)


def test_encoder_decoder_blocks_mixed_with_skip_blocks_raise():
    """JAX fails in the up loop on a config that mixes the encoder/decoder
    blocks (no skips) with blocks that pass skips; the port refuses it when
    built, naming ROADMAP R14."""
    kw = dict(in_channels=8, out_channels=8, block_out_channels=(32, 32, 64, 64), layers_per_block=1,
              norm_num_groups=8, attention_head_dim=8, cross_attention_dim=20, only_cross_attention=True,
              down_block_types=("DownBlock2D", "AttnDownEncoderBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"))
    x, t = jnp.zeros((1, 16, 8)), jnp.array([1])
    with pytest.raises(Exception):
        jax.eval_shape(JUNet(JConfig(**kw)).init, jax.random.PRNGKey(0), x, t)
    with pytest.raises(ValueError, match="R14"):
        UNet1DCondition(UNet1DConditionConfig(**kw))


def test_encoder_states_must_match_the_built_width():
    model = UNet1DCondition(UNet1DConditionConfig(**dict(TWO, **CROSS)), context_dim=20)
    with pytest.raises(ValueError, match="context_dim"):
        model(torch.zeros((1, 16, 8)), torch.tensor([1]))
    with pytest.raises(ValueError, match="context_dim"):
        UNet1DCondition(UNet1DConditionConfig(**dict(TWO, **CROSS)))(
            torch.zeros((1, 16, 8)), torch.tensor([1]), encoder_hidden_states=torch.zeros((1, 3, 20)))


VAEGAN = dict(sampling_rate=8000, inter_channels=8, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(4, 2), upsample_initial_channel=16, upsample_kernel_sizes=(8, 4))


def test_pipeline_infer_20_steps_matches_jax(rng):
    """zoo_k through `TTSPipeline.infer`: units -> bucket -> condition ->
    20-step DPM-Solver++ -> vocoder -> crop, from the same x_init."""
    jsys = _jsystem("zoo_k")
    jgen = HifiVAEGAN.random_init(JVAEGANConfig(**VAEGAN))
    dstate = convert.unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, jsys.params))
    pipe = TTSPipeline(
        Unit2MelSystem(Unit2MelConfig(attn_impl="pallas", **_zoo("zoo_k")), state_dict=dstate, device="cpu"),
        Vocoder("hifi-vaegan", VAEGANConfig(**VAEGAN), device="cpu",
                state_dict=convert.generator_from_jax(jax.tree_util.tree_map(np.asarray, jgen.generator_params))),
        codebook=None)
    units = rng.standard_normal((1, 13, 12)).astype(np.float32)
    x0 = rng.standard_normal((1, 64, 8)).astype(np.float32)  # the 13-frame bucket is 64

    @jax.jit
    def serve(dparams, gparams, units, x_init):
        padded = jnp.pad(units, ((0, 0), (0, 64 - units.shape[1]), (0, 0)), mode="edge")
        cond = jsys.condition(padded, spk_id=jnp.full((1, 1), 2), params=dparams)
        mel = jsys.diffusion.sample(dparams, cond, jax.random.PRNGKey(0), method="dpm-solver", infer_speedup=5,
                                    x_init=x_init)
        return mel, jgen.generator.apply({"params": gparams}, mel)[:, : 13 * 8]

    ref_mel, ref_wav = serve(jsys.params, jgen.generator_params, jnp.asarray(units), jnp.asarray(x0))
    spk = torch.full((1, 1), 2, dtype=torch.long)
    with torch.no_grad():
        mel = pipe.diffusion.infer(torch.from_numpy(units[:, list(range(13)) + [12] * 51]), spk_id=spk,
                                   method="dpm-solver", infer_speedup=5, x_init=torch.from_numpy(x0))
    wav = pipe.infer(torch.from_numpy(units), spk_id=2, infer_speedup=5, x_init=torch.from_numpy(x0))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=2e-3, rtol=2e-3)
    ref_wav = np.asarray(ref_wav)
    assert wav.shape == ref_wav.shape == (1, 13 * 8)
    peak = np.abs(ref_wav).max()
    np.testing.assert_allclose(wav.numpy(), ref_wav, atol=2e-3 * peak, rtol=2e-3)


def test_zoo_loss_and_gradients_match_jax(rng):
    """zoo_attn trains under attn_impl='xla': from the same weights, t and
    noise, the loss and the gradient of every parameter."""
    jsys = _jsystem("zoo_attn")
    params = jsys.params
    units, spec = _f(rng, B, 13, 12), _f(rng, B, 13, 8)
    spk, aug = np.array([[1], [3]], np.int32), _f(rng, B, 1)
    t, noise = np.array([3, 71], np.int32), _f(rng, B, 13, 8)

    def j_loss(params, units, spec, spk, aug, t, noise):
        d = jsys.diffusion
        cond = jsys.condition(units, None, spk, aug, params=params)
        x_noisy, cond, n = d._pad(d.q_sample(d.norm_spec(spec), t, noise), cond)
        eps = d._eps_fn(params, cond)(x_noisy, t)[:, :n]
        return jnp.mean((noise - eps) ** 2)

    ref, j_grads = jax.jit(jax.value_and_grad(j_loss))(params, *(jnp.asarray(a) for a in (units, spec, spk, aug, t,
                                                                                           noise)))
    sys_ = Unit2MelSystem(Unit2MelConfig(attn_impl="xla", **_zoo("zoo_attn")),
                          state_dict=convert.unit2mel_from_jax(params), device="cpu")
    sys_.module.train()
    d = sys_.diffusion
    tt, tnoise = torch.from_numpy(t).long(), torch.from_numpy(noise)
    cond = sys_.module.condition(torch.from_numpy(units), None, torch.from_numpy(spk).long(), torch.from_numpy(aug))
    x_noisy, cond, n = d._pad(d.q_sample(d.norm_spec(torch.from_numpy(spec)), tt, tnoise), cond)
    loss = ((tnoise - d.denoise_fn(None, torch.cat([x_noisy, cond], dim=-1), tt)[:, :n]) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    want = convert.unit2mel_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))
    got = {name: p.grad for name, p in sys_.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def _reference_names(state: dict) -> dict:
    """The port's state dict under the reference's torch names
    (`down_blocks.0.resnets.1`, `to_out.0`, `transformers.1`, ...)."""
    lists = ("down_blocks|up_blocks|resnets|attentions|transformer_blocks|transformers|downsamplers|upsamplers"
             "|to_out|net")
    return {re.sub(rf"\b({lists})_(\d+)\.", r"\1.\2.", k): v for k, v in state.items()}


IMPORTED = {name: (lambda name=name: Unit2MelConfig(**_zoo(name)).general_unet_config(), None) for name in ZOO}
IMPORTED.update({
    "conditioning": (lambda: UNet1DConditionConfig(**dict(
        TWO, **CROSS, time_embedding_type="fourier", addition_embed_type="text_time", addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=34, time_cond_proj_dim=6, class_embed_type="projection",
        encoder_hid_dim_type="text_proj")), 12),
    "norm_cross": (lambda: UNet1DConditionConfig(**dict(
        TWO, down_block_types=("KDownBlock2D", "KCrossAttnDownBlock2D"), mid_block_type=None,
        up_block_types=("KCrossAttnUpBlock2D", "KUpBlock2D"), num_class_embeds=5)), 20),
})


@pytest.mark.parametrize("name", sorted(IMPORTED))
def test_block_importer_gives_the_jax_tree(name):
    """Every leaf (norm_cross, add_k_proj, group_norm, skip_conv,
    skip_norm, time_proj, class_embedding, add_embedding, encoder_hid_proj,
    cond_proj, ...) goes through both importers to the same tree, and the
    converter loads that tree back as the same state."""
    make_cfg, context_dim = IMPORTED[name]
    model = UNet1DCondition(make_cfg(), context_dim=context_dim)
    state = {k: v.detach().clone().normal_(generator=torch.Generator().manual_seed(0))
             for k, v in model.state_dict().items()}
    ref_state = _reference_names(state)
    mine, theirs = import_torch.block_params_from_torch(ref_state), j_import.block_params_from_torch(ref_state)
    flat = convert._flatten(mine)
    assert flat.keys() == convert._flatten(theirs).keys()
    for key, value in convert._flatten(theirs).items():
        np.testing.assert_array_equal(flat[key], np.asarray(value), err_msg=key)
    model.load_state_dict(_convert(mine))
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key
