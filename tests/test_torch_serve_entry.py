"""The port's serve entry points against the JAX package's.

* `text/segment.py::split_sentences` equals JAX's on the cases of
  tests/test_segment.py and on a hypothesis corpus;
* `ops/audio_io.py`'s encoders are byte-identical to JAX's, and `read_wav`
  reads what they write as JAX's does;
* `models/lm/registry.py::roformer_config_from` gives JAX's config for
  `configs/config.yaml`, field for field;
* `TTSPipeline.tts_long_text` passes the stub-pipeline cases of
  tests/test_segment.py;
* `cli/infer_tts.py::build_pipeline(..., device="cpu")` on the shipped
  config shrunk to tiny widths (and a tiny vocoder) builds the pipeline
  JAX's `build_pipeline` builds: the same codebook and phones, and with the
  JAX weights carried across (`convert.*_from_jax`) the same greedy tokens
  and, from one x_init, the same waveform;
* `infer/load.py::load_native_pipeline` serves the EMA sidecar of a
  checkpoint the port's trainer wrote;
* the CLI writes a WAV on the CPU, plain and with `--long`;
* `cli/serve.py::main` serves /tts (behind its bearer token) and /healthz
  on the CPU, and returns when its HTTP server is shut down;
* `--weight-quant int8` serves through both CLIs (int8 UNet weights);
* what is not ported raises NotImplementedError:
  `type: llama`, a reference-format LM checkpoint; a vocoder checkpoint
  directory without the reference's files raises FileNotFoundError.

f32 on the CPU.  Tolerance: tokens, codebooks, bytes and configs exact; the
waveform atol/rtol 2e-3 (the sampler tolerance of tests/test_diffusion.py,
as in tests/test_torch_pipeline.py).
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from latent_diffusion_speech_tpu import config as j_config
from latent_diffusion_speech_tpu.cli.infer_tts import build_pipeline as j_build_pipeline
from latent_diffusion_speech_tpu.infer.tts import TTSPipeline as JTTSPipeline
from latent_diffusion_speech_tpu.models.vaegan import VAEGANConfig as JVAEGANConfig
from latent_diffusion_speech_tpu.ops import audio_io as j_audio_io
from latent_diffusion_speech_tpu.text.segment import split_sentences as j_split_sentences
from latent_diffusion_speech_tpu.train.lm_trainer import roformer_config_from as j_roformer_config_from
from latent_diffusion_speech_tpu_torch import config, convert
from latent_diffusion_speech_tpu_torch.cli import infer_tts, serve
from latent_diffusion_speech_tpu_torch.cli.infer_tts import build_pipeline
from latent_diffusion_speech_tpu_torch.infer import TTSPipeline
from latent_diffusion_speech_tpu_torch.infer.load import load_native_pipeline
from latent_diffusion_speech_tpu_torch.models.lm.registry import get_language_model, roformer_config_from
from latent_diffusion_speech_tpu_torch.models.vaegan import config as vaegan_config
from latent_diffusion_speech_tpu_torch.ops import audio_io
from latent_diffusion_speech_tpu_torch.text.segment import split_sentences
from latent_diffusion_speech_tpu_torch.train.diffusion_trainer import DiffusionTrainer

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config.yaml"
VAEGAN = dict(
    sampling_rate=8000, inter_channels=6, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 2),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 4),
)
TEXT = "Hello world, this is a test."


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread.  Under the parallel test run every
    worker's default thread pool spins against the others' for each small
    op, which made these tests 10-200x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- split_sentences ----------------------------------------------------------

SEGMENT_CASES = [
    ("今天天气真好。我们去公园。然后听音乐!", 8),
    ("你好。再见。好的。", 60),
    ("一二三,四五六七八九十一二三四五", 10),
    ("a" * 25, 10),
    *[("其一。其二,内容较长一些的句子;其三!其四?ABC DEF, and more.", b) for b in (6, 12, 30, 200)],
    ("", 60),
    ("\n\n", 60),
]


@pytest.mark.parametrize("text,max_chars", SEGMENT_CASES)
def test_split_sentences_matches_jax(text, max_chars):
    assert split_sentences(text, max_chars=max_chars) == j_split_sentences(text, max_chars=max_chars)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="ab ,，。！？!?；;…\n:：、—一二", max_size=80), st.integers(1, 40))
def test_split_sentences_matches_jax_on_a_corpus(text, max_chars):
    assert split_sentences(text, max_chars=max_chars) == j_split_sentences(text, max_chars=max_chars)


# -- audio_io -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37,), (50, 2)])
def test_wav_encoders_are_byte_identical(rng, shape):
    samples = np.clip(rng.standard_normal(shape).astype(np.float32) * 0.7, -1.5, 1.5)
    assert audio_io.pcm16_bytes(samples) == j_audio_io.pcm16_bytes(samples)
    for subtype in ("pcm16", "float32"):
        assert audio_io.wav_bytes(samples, 8000, subtype) == j_audio_io.wav_bytes(samples, 8000, subtype)
    for sr, ch in ((44100, 1), (16000, 2)):
        assert audio_io.wav_stream_header(sr, ch) == j_audio_io.wav_stream_header(sr, ch)


@pytest.mark.parametrize("subtype", ["pcm16", "float32"])
def test_read_wav_matches_jax(tmp_path, rng, subtype):
    path = tmp_path / "x.wav"
    audio_io.write_wav(path, rng.uniform(-1, 1, (40, 2)).astype(np.float32), 22050, subtype)
    got, sr = audio_io.read_wav(path)
    ref, ref_sr = j_audio_io.read_wav(path)
    assert sr == ref_sr == 22050
    np.testing.assert_array_equal(got, ref)


# -- the LM registry ----------------------------------------------------------


def test_roformer_config_from_matches_jax():
    got = roformer_config_from(config.load_config(CONFIG))
    ref = j_roformer_config_from(j_config.load_config(CONFIG))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_llama_raises():
    """`type: llama` builds the port's LlamaSystem (it raised until the
    Llama was ported) at the JAX mapping's geometry."""
    from latent_diffusion_speech_tpu.train.lm_trainer import llama_config_from as j_llama_config_from
    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaSystem

    cfg, j_cfg = config.load_config(CONFIG), j_config.load_config(CONFIG)
    for c in (cfg, j_cfg):
        c.text2semantic.model.type = "llama"
        c.text2semantic.model.decoder.hidden_size = 32
        c.text2semantic.model.moe_experts = 2
    lm = get_language_model(cfg, device="cpu")
    assert isinstance(lm, LlamaSystem) and not lm.module.training
    assert dataclasses.asdict(lm.cfg) == dataclasses.asdict(j_llama_config_from(j_cfg))


# -- tts_long_text ------------------------------------------------------------


class _StubPipeline:
    """Only what tts_long_text touches: vocoder sample rate + tts_batch."""

    class _V:
        vocoder_sample_rate = 8000

    vocoder = _V()
    tts = None

    def __init__(self):
        self.calls = []

    def tts_batch(self, pieces, language="ZH", spk_ids=None, **kw):
        self.calls.append((list(pieces), list(spk_ids), kw))
        return [(np.full(100, float(i)), 8000) for i in range(len(pieces))]


def test_long_text_batched_stitch_with_pauses():
    stub = _StubPipeline()
    wav, sr = TTSPipeline.tts_long_text(stub, "第一句。第二句。第三句。", max_chars=4, pause_ms=100,
                                        spk_id=3, method="ddim")
    assert sr == 8000
    (pieces, spk_ids, kw) = stub.calls[0]
    assert pieces == ["第一句。", "第二句。", "第三句。"]
    assert spk_ids == [3, 3, 3]
    assert kw["method"] == "ddim"
    gap = int(8000 * 0.1)
    assert len(wav) == 3 * 100 + 2 * gap
    assert wav[0] == 0.0 and wav[100 + gap] == 1.0 and wav[-1] == 2.0
    assert (wav[100: 100 + gap] == 0.0).all()
    ref, _ = JTTSPipeline.tts_long_text(_StubPipeline(), "第一句。第二句。第三句。", max_chars=4, pause_ms=100,
                                        spk_id=3, method="ddim")
    np.testing.assert_array_equal(wav, ref)


def test_long_text_empty_text():
    stub = _StubPipeline()
    wav, sr = TTSPipeline.tts_long_text(stub, "")
    assert wav.size == 0 and sr == 8000 and not stub.calls


# -- build_pipeline -----------------------------------------------------------


def _tiny(cfg, tmp_path):
    """The shipped config at tiny widths; the codebook and vocoder paths
    point where nothing exists."""
    cfg.common.n_spk = 4
    cfg.common.vocoder.ckpt = str(tmp_path / "no-vocoder")
    m = cfg.diffusion.model
    m.block_out_channels, m.n_heads, m.n_hidden, m.n_layers, m.out_dims = (8, 8), 2, 8, 1, 6
    lm = cfg.text2semantic.model
    lm.codebook_path = str(tmp_path / "no-codebook.npz")
    lm.semantic_kmeans_num = 32
    for stack in (lm.encoder, lm.decoder):
        stack.hidden_size, stack.num_attention_heads, stack.num_hidden_layers, stack.intermediate_size = 16, 2, 1, 16
    cfg.diffusion.train.expdir = str(tmp_path / "exp_diff")
    return cfg


@pytest.fixture
def tiny_vocoder(monkeypatch):
    """Both packages' build_pipeline make a tiny vocoder."""
    import latent_diffusion_speech_tpu.models.vocoder as j_vocoder

    monkeypatch.setattr(j_vocoder, "VAEGANConfig", lambda: JVAEGANConfig(**VAEGAN))
    monkeypatch.setattr(vaegan_config, "VAEGANConfig", lambda: _PORT_VAEGAN(**VAEGAN))


_PORT_VAEGAN = vaegan_config.VAEGANConfig


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_build_pipeline_matches_jax(tmp_path, tiny_vocoder):
    jpipe = j_build_pipeline(_tiny(j_config.load_config(CONFIG), tmp_path), dtype=jnp.float32)
    pipe = build_pipeline(_tiny(config.load_config(CONFIG), tmp_path), dtype=torch.float32, device="cpu")
    assert pipe.device.type == "cpu" and pipe.diffusion.cfg.attn_impl == jpipe.diffusion.cfg.attn_impl
    np.testing.assert_array_equal(pipe.codebook.codebook.numpy(), np.asarray(jpipe.codebook.codebook))
    assert dataclasses.asdict(pipe.lm.cfg) == dataclasses.asdict(jpipe.lm.cfg)
    pipe.diffusion.module.load_state_dict(convert.unit2mel_from_jax(_np(jpipe.diffusion.params)))
    pipe.lm.module.load_state_dict(convert.roformer_from_jax(_np(jpipe.lm.params)))
    pipe.vocoder.generator.load_state_dict(convert.generator_from_jax(_np(jpipe.vocoder.vocoder.generator_params)))

    phones, tones = pipe.text_to_phones(TEXT, "EN")
    ref_phones, ref_tones = jpipe.text_to_phones(TEXT, "EN")
    np.testing.assert_array_equal(phones, ref_phones)
    np.testing.assert_array_equal(tones, ref_tones)
    ref_t, ref_l = jpipe.lm.generate(phones[None], tones[None], spk_id=2, max_length=12, do_sample=False)
    got_t, got_l = pipe.lm.generate(phones[None], tones[None], spk_id=2, max_length=12, do_sample=False)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))

    # tokens -> units -> pad to the 64 bucket -> condition -> the config's
    # sampler (UniPC) from one x_init -> vocoder -> crop
    tokens = np.asarray(ref_t)[0, : int(ref_l[0])]
    tokens = tokens[tokens < 32][:10]
    n = len(tokens)
    x0 = np.random.default_rng(0).standard_normal((1, 64, 6)).astype(np.float32)
    jdiff, jvoc = jpipe.diffusion, jpipe.vocoder.vocoder

    @jax.jit
    def serve_ref(dparams, gparams, units, x_init):
        padded = jnp.pad(units, ((0, 0), (0, 64 - n), (0, 0)), mode="edge")
        cond = jdiff.condition(padded, spk_id=jnp.full((1, 1), 3), params=dparams)
        mel = jdiff.diffusion.sample(dparams, cond, jax.random.PRNGKey(0), method="unipc", infer_speedup=100,
                                     x_init=x_init)
        return jvoc.generator.apply({"params": gparams}, mel)[:, : n * 8]

    ref = np.asarray(serve_ref(jdiff.params, jvoc.generator_params, jpipe.semantic_to_units(tokens),
                               jnp.asarray(x0)))
    got = pipe.infer(pipe.semantic_to_units(tokens), spk_id=3, method="unipc", infer_speedup=100,
                     x_init=torch.from_numpy(x0))
    assert got.shape == ref.shape == (1, n * 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=2e-3)


def test_load_native_pipeline_serves_the_ema_sidecar(tmp_path, tiny_vocoder):
    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    cfg.diffusion.train.ema_decay = 0.9
    trainer = DiffusionTrainer(cfg, device="cpu")
    for step in (1, 2):
        trainer.step = step
        with torch.no_grad():
            for n, p in trainer.system.module.named_parameters():
                trainer.ema[n] = p.detach() * 0.5 + step  # an EMA unlike the live weights
        trainer.save()
    saved = {n: t.clone() for n, t in trainer.system.module.state_dict().items()}
    expdir = Path(cfg.diffusion.train.expdir)
    assert (expdir / "model_2.ema.ckpt").exists()

    for where, step in ((expdir, 2), (expdir / "model_1.ckpt", 1)):
        pipe = load_native_pipeline(cfg, where, dtype=torch.float32, device="cpu")
        state = pipe.diffusion.module.state_dict()
        assert state.keys() == saved.keys()
        params = dict(trainer.system.module.named_parameters())
        for n, t in state.items():
            want = params[n].detach() * 0.5 + step if n in params else saved[n]
            assert torch.equal(t, want), n


LONG_TEXT = "Hello there, my good friend! How are you today? The weather is fine and the sun is out!"


def test_cli_writes_wavs_on_the_cpu(tmp_path, tiny_vocoder):
    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    cfg_path = tmp_path / "tiny.yaml"
    config.save_config(cfg, cfg_path)
    assert len(split_sentences(LONG_TEXT)) == 2  # --long synthesizes two pieces
    for extra, name in (([], "plain.wav"), (["--long", "--pause-ms", "50"], "long.wav")):
        out = tmp_path / name
        infer_tts.main(["-c", str(cfg_path), "-l", "EN", "-i", LONG_TEXT, "-o", str(out),
                        "--speedup", "100", "--device", "cpu", *extra])
        wav, sr = audio_io.read_wav(out)
        assert sr == 8000 and wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()


def test_serve_main_answers_and_shuts_down(tmp_path, tiny_vocoder, monkeypatch):
    """`cli/serve.py::main` as a user starts it, on the CPU on port 0 in a
    thread: its argparse defaults, `with TTSServer`, the bearer token and
    `serve_forever`.  One /tts POST (401 without the token, a WAV with it),
    /healthz, then shutdown: main returns and its TTSServer is closed."""
    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    cfg_path = tmp_path / "tiny.yaml"
    config.save_config(cfg, cfg_path)
    started = []

    class Recorded(serve.TTSHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)

    monkeypatch.setattr(serve, "TTSHTTPServer", Recorded)
    errors = []

    def run():
        try:
            serve.main(["-c", str(cfg_path), "--port", "0", "--speedup", "100", "--device", "cpu",
                        "--auth-token", "sesame"])
        except BaseException as e:  # noqa: BLE001 — reported by the test thread
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while not started and thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert started and not errors, errors
    httpd = started[0]
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = json.dumps({"text": TEXT, "language": "EN", "spk_id": 2}).encode()
    try:
        with pytest.raises(urllib.error.HTTPError) as denied:
            urllib.request.urlopen(urllib.request.Request(url + "/tts", data=body), timeout=60)
        assert denied.value.code == 401
        req = urllib.request.Request(url + "/tts", data=body, headers={"Authorization": "Bearer sesame"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
            wav_path = tmp_path / "served.wav"
            wav_path.write_bytes(resp.read())
        wav, sr = audio_io.read_wav(wav_path)
        assert sr == 8000 and wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["requests_served"] == 1 and health["batches_served"] == 1
        assert health["requests_failed"] == 0 and health["requests_rejected"] == 0
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    assert httpd.socket.fileno() == -1  # main closed its socket


# -- what is not ported raises ------------------------------------------------


@pytest.mark.parametrize("cli", [infer_tts, serve])
def test_weight_quant_int8_raises(cli, tmp_path, tiny_vocoder, monkeypatch):
    """`--weight-quant int8` serves (it raised until int8 serving weights
    were ported): the CLI builds the pipeline with int8 UNet weights; the
    infer CLI writes its WAV through them (the UNet quantized once per
    sampler call), the daemon's pipeline is taken as built and stopped
    before it listens."""
    from latent_diffusion_speech_tpu_torch.models.diffusion import unit2mel

    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    cfg_path = tmp_path / "tiny.yaml"
    config.save_config(cfg, cfg_path)
    built, quantized = [], []
    real_build, real_quant = infer_tts.build_pipeline, unit2mel.quantize_tree_int8

    class Built(Exception):
        pass

    def build(*a, **kw):
        built.append(real_build(*a, **kw))
        if cli is serve:
            raise Built
        return built[-1]

    monkeypatch.setattr(infer_tts, "build_pipeline", build)
    monkeypatch.setattr(unit2mel, "quantize_tree_int8", lambda p: quantized.append(1) or real_quant(p))
    args = ["-c", str(cfg_path), "--weight-quant", "int8", "--device", "cpu", "--speedup", "100"]
    if cli is infer_tts:
        out = tmp_path / "int8.wav"
        cli.main(args + ["-l", "EN", "-i", TEXT, "-o", str(out)])
        wav, sr = audio_io.read_wav(out)
        assert len(wav) > 0 and np.isfinite(wav).all() and quantized
    else:
        with pytest.raises(Built):
            cli.main(args + ["--port", "0"])
    assert built[0].diffusion.weight_quant == "int8"


def test_llama_config_raises_in_build_pipeline(tmp_path, tiny_vocoder):
    """A `type: llama` config builds a Llama pipeline (it raised until the
    Llama was ported): `tts` serves; `tts_batch` raises, as the JAX
    pipeline's does (ROADMAP R11)."""
    from latent_diffusion_speech_tpu_torch.models.lm.llama import LlamaSystem

    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    cfg.text2semantic.model.type = "llama"
    pipe = build_pipeline(cfg, dtype=torch.float32, device="cpu")
    assert isinstance(pipe.lm, LlamaSystem)
    wav, sr = pipe.tts(TEXT, language="EN", max_length=16, infer_speedup=100)
    assert sr == VAEGAN["sampling_rate"] and np.isfinite(wav).all()
    with pytest.raises(TypeError, match="Llama LM has no batched decode"):
        pipe.tts_batch([TEXT], language="EN", max_length=16)


def test_lm_checkpoint_raises_in_build_pipeline(tmp_path):
    """The LM trainer's checkpoints load (tests/test_torch_lm_train.py);
    the reference's `model_<step>.pt`, as a file or as the only checkpoint
    of a directory, raises and names `infer/load.py::load_reference_pipeline`
    and `cli/verify_import.py`, which read it, and a path
    that does not exist raises FileNotFoundError."""
    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    (tmp_path / "lm").mkdir()
    (tmp_path / "lm" / "model_100.pt").write_bytes(b"")
    for ckpt in (tmp_path / "lm", tmp_path / "lm" / "model_100.pt"):
        with pytest.raises(NotImplementedError,
                           match=r"infer/load\.py::load_reference_pipeline .*cli/verify_import\.py"):
            build_pipeline(cfg, lm_ckpt=str(ckpt), device="cpu")
    with pytest.raises(FileNotFoundError):
        build_pipeline(cfg, lm_ckpt=str(tmp_path / "no-such-lm"), device="cpu")


def test_vocoder_checkpoint_directory_raises(tmp_path):
    """An existing `common.vocoder.ckpt` directory is loaded (as in JAX),
    so one without the reference's `decoder.pth` raises instead of serving
    seeded weights (tests/test_torch_codec.py serves a real pair)."""
    cfg = _tiny(config.load_config(CONFIG), tmp_path)
    (tmp_path / "hifi-vaegan").mkdir()
    cfg.common.vocoder.ckpt = str(tmp_path / "hifi-vaegan")
    with pytest.raises(FileNotFoundError, match="decoder.pth"):
        build_pipeline(cfg, device="cpu")
