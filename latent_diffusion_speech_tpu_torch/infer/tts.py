"""End-to-end TTS serving: text -> phones -> AR LM -> semantic tokens ->
k-means centroid units -> 20-step DPM-Solver++ diffusion -> HiFi-VAEGAN
waveform.

Counterpart of `latent_diffusion_speech_tpu/infer/tts.py::TTSPipeline` (the
serve path: `tts`, `tts_from_phones`, `tts_batch`, `tts_long_text`,
`mel2wav` and the stages under them), with the same signatures except that
`rng` keys become `torch.Generator`s.  `tts_batch` keeps the phone, length
and batch buckets and the per-item crops, so the server's batching loop
(`infer/server.py`) can drive it.  It runs eagerly; the LM decode is one K1
kernel launch on the card and every UNet attention one K4 launch, or one K5
launch with `attn_impl="pallas"` (the flagship or the general denoiser: it
takes any `Unit2MelSystem`).  `infer_from_long_audio` (SVC) is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from latent_diffusion_speech_tpu_torch.models.diffusion.unit2mel import Unit2MelSystem
from latent_diffusion_speech_tpu_torch.models.lm.roformer import RoformerSystem
from latent_diffusion_speech_tpu_torch.models.vocoder import Vocoder
from latent_diffusion_speech_tpu_torch.quantize.codebook import EuclideanCodebook

__all__ = ["TTSPipeline"]


def _bucket(n: int, multiple: int = 64) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


class TTSPipeline:
    def __init__(
        self,
        diffusion: Unit2MelSystem,
        vocoder: Vocoder,
        lm: Optional[RoformerSystem] = None,
        codebook: Optional[np.ndarray] = None,
        device=None,
    ):
        """device: where the pipeline's tensors live (default: the diffusion
        model's device); every stage must be on it."""
        self.device = torch.device(device) if device is not None else diffusion.device
        for part in (diffusion, vocoder, lm):
            if part is not None and part.device != self.device:
                raise ValueError(f"{type(part).__name__} is on {part.device}, pipeline on {self.device}")
        self.diffusion = diffusion
        self.vocoder = vocoder
        self.lm = lm
        self.codebook = EuclideanCodebook(codebook, self.device) if codebook is not None else None

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- text -> semantic ----------------------------------------------------

    def text_to_phones(self, text: str, language: str = "ZH") -> Tuple[np.ndarray, np.ndarray]:
        from latent_diffusion_speech_tpu_torch.text import text_to_sequence

        (phones, tones, _lang), _ = text_to_sequence(text, language)
        return np.asarray(phones, np.int32), np.asarray(tones, np.int32)

    def generate_semantic(
        self,
        phones: np.ndarray,
        tones: np.ndarray,
        spk_id: int = 1,
        max_length: int = 1024,
        top_k: int = 5,
        end_gate_threshold: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> np.ndarray:
        """Run the LM; returns semantic token ids (L,) with BOS/EOS/PAD stripped."""
        if self.lm is None:
            raise ValueError("pipeline built without a language model")
        tokens, lengths = self.lm.generate(
            np.asarray(phones)[None], np.asarray(tones)[None], spk_id=spk_id,
            max_length=max_length, top_k=top_k, end_gate_threshold=end_gate_threshold,
            generator=generator,
        )
        n = int(lengths[0])
        toks = tokens[0, :n].cpu().numpy()
        return toks[toks < self.lm.cfg.semantic_kmeans_num].astype(np.int32)

    def semantic_to_units(self, tokens: np.ndarray) -> torch.Tensor:
        """Token ids -> unit embeddings (1, L, D) via the k-means centroids."""
        if self.codebook is None:
            raise ValueError("pipeline built without a semantic codebook")
        return self.codebook.dequantize(torch.as_tensor(np.asarray(tokens)))[None]

    # -- units -> audio ------------------------------------------------------

    @torch.no_grad()
    def infer(
        self,
        units: torch.Tensor,
        spk_id=1,
        method: str = "dpm-solver",
        infer_speedup: int = 50,
        generator: Optional[torch.Generator] = None,
        pad_to_bucket: bool = True,
        x_init: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """units (B, T, D) -> waveform (B, T*hop): pad to the length bucket
        (edge), condition -> sampler -> vocoder -> crop.

        spk_id: a scalar, or a (B,) array for per-item speakers.  x_init:
        optional (B, T_bucket, M) starting noise (parity checks)."""
        units = torch.as_tensor(units, device=self.device)
        B, T = units.shape[:2]
        padded_T = _bucket(T) if pad_to_bucket else T
        if padded_T != T:
            units = torch.cat([units, units[:, -1:].expand(B, padded_T - T, -1)], dim=1)
        spk = torch.as_tensor(np.asarray(spk_id, np.int64), device=self.device).reshape(-1, 1)
        spk = spk.expand(B, 1)
        mel = self.diffusion.infer(
            units, generator, spk_id=spk, method=method, infer_speedup=infer_speedup,
            x_init=x_init,
        )
        wav = self.vocoder.infer(mel)
        return wav[:, : T * self.vocoder.vocoder_hop_size]

    @torch.no_grad()
    def mel2wav(self, mel: torch.Tensor) -> torch.Tensor:
        return self.vocoder.infer(mel)

    # -- full TTS ------------------------------------------------------------

    def tts(
        self,
        text: str,
        language: str = "ZH",
        spk_id: int = 1,
        method: str = "dpm-solver",
        infer_speedup: int = 50,
        max_length: int = 1024,
        top_k: int = 5,
        end_gate_threshold: Optional[float] = None,
        seed: int = 0,
    ) -> Tuple[np.ndarray, int]:
        """Text -> (waveform (T,), sample_rate)."""
        phones, tones = self.text_to_phones(text, language)
        return self.tts_from_phones(
            phones, tones, spk_id=spk_id, method=method, infer_speedup=infer_speedup,
            max_length=max_length, top_k=top_k, end_gate_threshold=end_gate_threshold,
            seed=seed,
        )

    @torch.no_grad()
    def tts_from_phones(
        self, phones, tones, spk_id=1, method="dpm-solver", infer_speedup=50,
        max_length=1024, top_k=5, end_gate_threshold=None, seed=0,
    ) -> Tuple[np.ndarray, int]:
        gen = self._generator(seed)
        tokens = self.generate_semantic(
            phones, tones, spk_id=spk_id, max_length=max_length, top_k=top_k,
            end_gate_threshold=end_gate_threshold, generator=gen,
        )
        sr = self.vocoder.vocoder_sample_rate
        if len(tokens) == 0:
            return np.zeros(0, np.float32), sr
        units = self.semantic_to_units(tokens)
        wav = self.infer(units, spk_id=spk_id, method=method, infer_speedup=infer_speedup,
                         generator=gen)
        return wav[0].float().cpu().numpy(), sr

    def tts_long_text(
        self,
        text: str,
        language: str = "ZH",
        spk_id: int = 1,
        pause_ms: float = 180.0,
        max_chars: int = 60,
        batched: bool = True,
        **kw,
    ) -> Tuple[np.ndarray, int]:
        """Long-text TTS: split into sentence-sized pieces
        (`text/segment.py`), synthesize them (as one `tts_batch` call by
        default, else one `tts` each) and stitch them with `pause_ms` of
        silence between pieces.  `kw` goes to `tts_batch` / `tts` (method,
        infer_speedup, top_k, seed, ...)."""
        from latent_diffusion_speech_tpu_torch.text.segment import split_sentences

        pieces = split_sentences(text, max_chars=max_chars)
        sr = self.vocoder.vocoder_sample_rate
        if not pieces:
            return np.zeros(0, np.float32), sr
        if batched:
            results = self.tts_batch(pieces, language=language, spk_ids=[spk_id] * len(pieces), **kw)
        else:
            results = [self.tts(p, language=language, spk_id=spk_id, **kw) for p in pieces]
        gap = np.zeros(int(round(sr * pause_ms / 1000.0)), np.float32)
        chunks: list = []
        for i, (wav, _) in enumerate(results):
            if i:
                chunks.append(gap)
            chunks.append(np.asarray(wav, np.float32))
        return np.concatenate(chunks), sr

    @torch.no_grad()
    def tts_batch(
        self,
        texts,
        language: str = "ZH",
        spk_ids=None,
        method: str = "dpm-solver",
        infer_speedup: int = 50,
        max_length: int = 1024,
        top_k: int = 5,
        end_gate_threshold: Optional[float] = None,
        seed: int = 0,
        phone_bucket: int = 16,
        batch_bucket: bool = True,
    ):
        """Batched serve: N texts -> list of (waveform, sample_rate).

        Phones pad to a shared bucket (multiple of `phone_bucket`) with
        encoder masks and the LM decodes every sequence in one call; the
        generated sequences are grouped by latent-length bucket and diffusion
        + vocoder run once per bucket, each item edge-padded to the bucket and
        cropped back to its own token count.  `batch_bucket` pads the batch
        dimension to the next power of two (pad rows replicate row 0; their
        outputs are dropped)."""
        if self.lm is None or self.codebook is None:
            raise ValueError("tts_batch needs a language model and a codebook")
        seqs = [self.text_to_phones(t, language) for t in texts]
        B = len(seqs)
        L = max(len(p) for p, _ in seqs)
        L = max(phone_bucket, ((L + phone_bucket - 1) // phone_bucket) * phone_bucket)
        B_pad = (1 << (B - 1).bit_length()) if batch_bucket and B > 0 else B
        phones = np.full((B_pad, L), self.lm.cfg.phone_pad, np.int64)
        tones = np.zeros((B_pad, L), np.int64)
        enc_mask = np.zeros((B_pad, L), np.int64)
        spk = np.asarray(spk_ids if spk_ids is not None else [1] * B, np.int64)
        spk = np.concatenate([spk, np.repeat(spk[:1], B_pad - B)])
        for b in range(B_pad):
            p, t = seqs[b] if b < B else seqs[0]  # pad rows replicate row 0
            phones[b, : len(p)] = p
            tones[b, : len(t)] = t
            enc_mask[b, : len(p)] = 1

        gen = self._generator(seed)
        tokens, lengths = self.lm.generate(
            phones, tones, spk_id=np.repeat(spk[:, None], L, axis=1), attention_mask=enc_mask,
            max_length=max_length, top_k=top_k, end_gate_threshold=end_gate_threshold,
            generator=gen,
        )
        tokens_np = tokens[:B].cpu().numpy()
        lengths_np = lengths[:B].cpu().numpy()
        K = self.lm.cfg.semantic_kmeans_num
        sr = self.vocoder.vocoder_sample_rate
        hop = self.vocoder.vocoder_hop_size
        centroids = self.codebook.codebook

        out = [None] * B
        buckets: dict = {}
        for b in range(B):
            toks = tokens_np[b, : int(lengths_np[b])]
            toks = toks[toks < K].astype(np.int64)
            if len(toks) == 0:
                out[b] = (np.zeros(0, np.float32), sr)
                continue
            buckets.setdefault(_bucket(len(toks)), []).append((b, toks))

        for Lb, items in sorted(buckets.items()):
            n = len(items)
            n_pad = (1 << (n - 1).bit_length()) if batch_bucket else n
            rows = []
            for j in range(n_pad):
                _, toks = items[j] if j < n else items[0]  # pad rows replicate
                emb = centroids[torch.as_tensor(toks, device=self.device)]
                rows.append(torch.cat([emb, emb[-1:].expand(Lb - len(toks), -1)]))  # edge-pad
            units = torch.stack(rows)  # (n_pad, Lb, D)
            spk_rows = [int(spk[b]) for b, _ in items] + [int(spk[items[0][0]])] * (n_pad - n)
            wavs = self.infer(units, spk_id=np.asarray(spk_rows), method=method,
                              infer_speedup=infer_speedup, generator=gen)
            wavs = wavs.float().cpu().numpy()
            for j, (b, toks) in enumerate(items):
                out[b] = (wavs[j, : len(toks) * hop], sr)
        return out
