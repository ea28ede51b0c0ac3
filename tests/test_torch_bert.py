"""The text-mode front end in the port against the JAX package: WordPiece,
BERT / MegatronBert, `text/bert.py` and stage 16's 'text' mode.

Weights come from a seeded port module through the reference's HF layouts
(`chip_smoke.reference_bert_state`), read by both packages' importers;
inputs from a numpy seed; f32 on the CPU (3 layers, C=32, H=2, V=40).
Tolerances: hidden states rtol 2e-4, atol 2e-5 (tests/test_bert_text_mode.py's
against HF); bf16 against JAX's bf16 no further than JAX's own bf16 is from
its f32 (a noise bound); WordPiece ids, importer trees and stage 16's files
exactly.  No `transformers`: the JAX extractor takes an object with HF's
`config` and `state_dict()`.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import reference_bert_state
from latent_diffusion_speech_tpu.cli.preprocess_tts import process_tts as j_process_tts
from latent_diffusion_speech_tpu.models import bert as j_bert
from latent_diffusion_speech_tpu.text import bert as j_text_bert
from latent_diffusion_speech_tpu.text import wordpiece as j_wordpiece
from latent_diffusion_speech_tpu_torch import convert
from latent_diffusion_speech_tpu_torch.cli.preprocess_tts import process_tts
from latent_diffusion_speech_tpu_torch.models.bert import BertConfig, BertEncoderModel, bert_params_from_torch
from latent_diffusion_speech_tpu_torch.ops.layers import cast_compute_dtype, seeded
from latent_diffusion_speech_tpu_torch.text import bert as text_bert
from latent_diffusion_speech_tpu_torch.text.wordpiece import WordPieceTokenizer, find_vocab_file

RTOL, ATOL = 2e-4, 2e-5
VOCAB = (  # tests/test_bert_text_mode.py's vocabulary
    "[PAD] [UNK] [CLS] [SEP] [MASK] "
    "你 好 今 天 气 真 世 界 的 我 们 一 起 去 公 园 "
    "hello world un ##aff ##able play ##ing , . ! ?"
).split()
TEXTS = ["你好世界", "hello world!", "unaffable playing, 今天天气真好.", "UNAFFABLE Hello 你好",
         "xyzzy 你好", "  tab\tand  newline\n Héllo wörld ", "playing!!, ?unaff"]
GEOM = dict(vocab_size=40, hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("bert") / "vocab.txt"
    p.write_text("\n".join(VOCAB), encoding="utf-8")
    return p


def _hf_like(pre_ln: bool, seed: int = 0):
    """(port module, an object with HF's `config` and `state_dict()` holding
    its weights in the reference's layout)."""
    cfg = BertConfig(**GEOM, pre_ln=pre_ln)
    module = seeded(lambda: BertEncoderModel(cfg), seed)
    with torch.no_grad():  # biases and norms off their init values
        for name, p in module.named_parameters():
            if not name.endswith("weight") or "ln" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    state = reference_bert_state(module.state_dict(), pre_ln)
    hf_cfg = SimpleNamespace(model_type="megatron-bert" if pre_ln else "bert", layer_norm_eps=1e-12,
                             type_vocab_size=2, **{k: v for k, v in GEOM.items()})
    return module.eval(), SimpleNamespace(config=hf_cfg, state_dict=lambda: state)


def test_wordpiece_matches_jax(vocab_file, monkeypatch):
    mine, theirs = WordPieceTokenizer(vocab_file), j_wordpiece.WordPieceTokenizer(vocab_file)
    for text in TEXTS:
        assert mine.encode(text) == theirs.encode(text), text
        assert mine.encode(text, add_special_tokens=False) == theirs.encode(text, add_special_tokens=False)
    assert (mine.cls_token_id, mine.sep_token_id, mine.pad_token_id, mine.vocab_size) == (2, 3, 0, len(VOCAB))
    assert mine.encode("xyzzy")[1] == ["[CLS]", "[UNK]", "[SEP]"]
    monkeypatch.setenv("LDS_BERT_VOCAB", str(vocab_file))
    assert find_vocab_file("/nonexistent") == j_wordpiece.find_vocab_file("/nonexistent") == vocab_file
    monkeypatch.delenv("LDS_BERT_VOCAB")
    assert find_vocab_file(str(vocab_file.parent)) == vocab_file and find_vocab_file("/nonexistent") is None


@pytest.mark.parametrize("pre_ln", [False, True], ids=["bert", "megatron"])
def test_importer_and_hidden_states_match_jax(pre_ln, rng):
    """Both importers give the same tree (a `bert.` prefix too); every
    hidden state of a padded batch matches JAX's, [-3] the reference's."""
    module, hf = _hf_like(pre_ln)
    cfg = BertConfig.from_hf(hf.config)
    assert cfg.pre_ln == pre_ln
    state = hf.state_dict()
    mine = bert_params_from_torch({f"bert.{k}": v for k, v in state.items()}, cfg)
    theirs = j_bert.bert_params_from_torch(state, j_bert.BertConfig.from_hf(hf.config))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)))
    port = BertEncoderModel(cfg)
    port.load_state_dict(convert.bert_from_jax(mine))
    assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(), module.state_dict().values()))

    ids = rng.integers(0, GEOM["vocab_size"], (2, 11))
    types = rng.integers(0, 2, (2, 11))
    mask = np.ones((2, 11), np.int32)
    mask[1, 7:] = 0
    jm = j_bert.BertEncoderModel(j_bert.BertConfig.from_hf(hf.config))
    want = jax.jit(jm.apply)({"params": jax.tree_util.tree_map(jnp.asarray, theirs)}, jnp.asarray(ids),
                             jnp.asarray(types), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(types), torch.from_numpy(mask))
    assert len(got) == len(want) == GEOM["num_hidden_layers"] + 1
    for j, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f"hidden_states[{j}]")

    # bf16 products (f32 norms, embeddings and softmax, as JAX's `dtype`)
    want16 = jax.jit(j_bert.BertEncoderModel(jm.cfg, dtype=jnp.bfloat16).apply)(
        {"params": jax.tree_util.tree_map(jnp.asarray, theirs)}, jnp.asarray(ids))[-3]
    with torch.no_grad():
        got16 = cast_compute_dtype(port, torch.bfloat16)(torch.from_numpy(ids))[-3]
    assert got16.dtype == torch.float32
    noise = np.abs(np.asarray(want16, np.float32) - np.asarray(want[-3])).max()
    assert np.abs(got16.numpy() - np.asarray(want16, np.float32)).max() <= noise


def test_bert_features_match_jax(vocab_file, rng):
    """`get_bert_feature`: hidden_states[-3] rows repeated by word2ph,
    transposed, as JAX's; the same from a local checkpoint directory
    (config.json + pytorch_model.bin, read without transformers)."""
    import json

    _, hf = _hf_like(False, seed=2)
    text = "你好世界"
    word2ph = [1] + [2] * len(text) + [1]
    tok = WordPieceTokenizer(vocab_file)
    got = text_bert.get_bert_feature(text, word2ph, tokenizer=tok,
                                     extractor=text_bert.NativeBertFeatures(hf_model=hf, device="cpu"))
    want = j_text_bert.get_bert_feature(text, word2ph, tokenizer=j_wordpiece.WordPieceTokenizer(vocab_file),
                                        extractor=j_text_bert.NativeBertFeatures(hf_model=hf))
    assert got.shape == want.shape == (GEOM["hidden_size"], sum(word2ph))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    ckpt = vocab_file.parent / "snapshot"
    ckpt.mkdir(exist_ok=True)
    (ckpt / "config.json").write_text(json.dumps(vars(hf.config)), encoding="utf-8")
    torch.save(hf.state_dict(), ckpt / "pytorch_model.bin")
    (ckpt / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    local = text_bert.get_bert_feature(text, word2ph, cache_dir=str(ckpt), device="cpu")
    np.testing.assert_array_equal(local, got)


def test_mock_only_when_vocab_or_weights_are_missing(vocab_file, tmp_path, monkeypatch):
    """Both packages give the zero mock with no vocabulary or no weights;
    the port lets any other failure through (JAX's returns the mock for
    every exception, which would hide a failed CUDA launch)."""
    monkeypatch.delenv("LDS_BERT_VOCAB", raising=False)
    for fn in (text_bert.get_bert_feature, j_text_bert.get_bert_feature):
        out = fn("你好", [1, 2, 2, 1], cache_dir="/nonexistent")
        assert out.shape == (1024, 6) and not out.any()
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    no_weights = str(tmp_path)  # a vocab.txt, no checkpoint
    out = text_bert.get_bert_feature("你好", [1, 2, 2, 1], cache_dir=no_weights, device="cpu")
    assert out.shape == (1024, 6) and not out.any()
    assert not j_text_bert.get_bert_feature("你好", [1, 2, 2, 1], cache_dir=no_weights).any()

    class Broken:
        def features(self, ids):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    tok = WordPieceTokenizer(vocab_file)
    with pytest.raises(RuntimeError, match="CUDA error"):
        text_bert.get_bert_feature("你好", [1, 2, 2, 1], tokenizer=tok, extractor=Broken())
    assert not j_text_bert.get_bert_feature("你好", [1, 2, 2, 1], tokenizer=tok, extractor=Broken()).any()
    with pytest.raises(FileNotFoundError, match="LDS_BERT_VOCAB"):
        text_bert.get_bert_token("你好", cache_dir="/nonexistent")


def test_stage_16_text_mode_writes_jax_files(vocab_file, tmp_path, monkeypatch):
    """(ids, [], [], []) object tuples, the same bytes' worth as JAX's."""
    monkeypatch.setenv("LDS_BERT_VOCAB", str(vocab_file))
    roots = []
    for name in ("port", "jax"):
        for spk, lines in (("1", ["0|你好世界", "1|hello world!"]),
                           ("2", ["0|unaffable playing, 今天天气真好."])):
            d = tmp_path / name / "audio" / spk
            d.mkdir(parents=True)
            for line in lines:
                (d / f"{line.split('|')[0]}.wav").write_bytes(b"")
            (d / "utt_text.txt").write_text("\n".join(lines), encoding="utf-8")
        roots.append(tmp_path / name)
    got, want = list(process_tts(roots[0], mode="text")), list(j_process_tts(roots[1], mode="text"))
    assert got == want and len(got) == 3
    for rel, _ in got:
        a = np.load(roots[0] / "utt" / (rel + ".npy"), allow_pickle=True)
        b = np.load(roots[1] / "utt" / (rel + ".npy"), allow_pickle=True)
        assert a.dtype == b.dtype == object and len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y)
        assert a[0][0] == 2 and a[0][-1] == 3 and all(len(x) == 0 for x in a[1:])
