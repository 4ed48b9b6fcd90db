"""Voice cloning in the port: reference speech -> GE2E embedding ->
Tacotron2 -> WaveFlow -> wav (counterpart of
``recipes/tacotron2_aishell3/voice_cloning.py``; reference:
examples/tacotron2_aishell3/voice_cloning.ipynb).

1. The reference wav is read at 16 kHz and turned into a 40-band
   natural-log mel (``LogMelFBank``, n_fft 512, hop 160, window 400), whose
   partial windows the GE2E encoder embeds (``embed_utterance``).
2. Each line of ``--text`` (``<utt_id> <pinyin syllables>``) becomes phone
   ids through the rule-generated lexicon and ``--phones-dict``, cut and
   zero-padded to ``--max-text-len``, and the conditioned
   ``Tacotron2.infer`` runs all ``--max-decoder-steps`` steps on it (with
   the YAML's stop token off, the attention peak ends the utterance).  The
   program has one static shape, (1, max-text-len): on the card it is one
   CUDA graph (``utils/graphs.py::CapturedProgram``), captured once and
   replayed for every line, as the JAX recipe jits it once; the prenet's
   always-on dropout masks are drawn once, from seed 0, before the loop,
   as the JAX recipe's fixed key gives every line the same masks.
3. ``--stat`` (the mel's mean and scale) undoes the normalisation.
4. With ``--waveflow-checkpoint`` the WaveFlow vocoder turns the
   utterance's frames (not padded: padding changes the samples) into a
   wav, its noise drawn from a generator seeded 0 for every line as the
   JAX recipe's fixed key; the mel's length changes with every line, so
   the sampler runs eagerly rather than as a graph a length.  Without a
   vocoder the mel is written as ``.npy``.

TF32 is off.  Each line prints its frames and the host-clock times
(synchronised) of its decode and vocoder; ``main`` returns them with the
embedding's time and the capture's.  Checkpoints are any the JAX package
or the port writes (``bridge.load_checkpoint_params``).

Usage:
  python -m parakeet_tpu_torch.recipes.tacotron2_aishell3.voice_cloning \\
      --config recipes/tacotron2_aishell3/conf/default.yaml \\
      --checkpoint exp/vc/checkpoints/snapshot_iter_N.npz \\
      --ge2e-checkpoint exp/ge2e/checkpoints/snapshot_iter_M.npz \\
      --ref-wav target_speaker.wav --phones-dict dump/phone_id_map.txt \\
      --text sentences_pinyin.txt \\
      --waveflow-config recipes/waveflow/conf/default.yaml \\
      --waveflow-checkpoint exp/waveflow/checkpoints/snapshot_iter_K.npz \\
      --output-dir cloned [--device cpu]
"""
import argparse
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ...audio.codec import load_wav, save_wav
from ...audio.features import LogMelFBank
from ...bridge import load_checkpoint_params
from ...frontend.generate_lexicon import generate_lexicon
from ...models import ConditionalWaveFlow, Tacotron2, embed_utterance
from ...ops.normalizer import ZScore
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..ge2e.inference import load_encoder
from ..synthesis import Stopwatch, TextProgram

__all__ = ["main", "embed_reference", "phone_ids", "ClonedSpeech",
           "REF_SR"]

REF_SR = 16000
# the prenet's masks and the vocoder's noise: one seed for every line
MASK_SEED, NOISE_SEED = 0, 0


def embed_reference(ref_wav, ge2e_checkpoint, device) -> np.ndarray:
    """The reference wav's (256,) GE2E embedding: the JAX recipe's mel
    (16 kHz, 40 bands, base e) through the shared partial-window helper,
    the encoder on ``device``."""
    encoder = load_encoder(ge2e_checkpoint, device, n_mels=40)
    wav, _ = load_wav(ref_wav, sr=REF_SR)
    mel = LogMelFBank(sr=REF_SR, n_fft=512, hop_length=160, win_length=400,
                      n_mels=40, fmin=0,
                      fmax=8000).get_log_mel_fbank(wav, base="e")
    return embed_utterance(encoder, mel)


def phone_ids(pinyin: str, lexicon: Dict[str, str],
              vocab: Dict[str, int]) -> List[int]:
    """Phone ids of space-separated pinyin syllables; syllables not in the
    lexicon and phones not in the vocabulary are skipped, as in JAX."""
    ids = []
    for syll in pinyin.split():
        for p in lexicon.get(syll, "").split():
            if p in vocab:
                ids.append(vocab[p])
    return ids


class ClonedSpeech(TextProgram):
    """``Tacotron2.infer`` conditioned on one speaker embedding at the
    static shape (1, ``max_text_len``): one CUDA graph on the card when
    ``graph``, else eager (``recipes/synthesis.py::TextProgram``).
    ``inputs`` are its static buffers."""

    def __init__(self, model: Tacotron2, spk_emb: np.ndarray,
                 max_text_len: int, max_decoder_steps: int,
                 device: torch.device, graph: bool):
        self.model, self.steps = model, max_decoder_steps
        keep = model.prenet_masks(1, max_decoder_steps,
                                  torch.Generator().manual_seed(MASK_SEED),
                                  "cpu")
        inputs = {
            "text": torch.zeros((1, max_text_len), dtype=torch.int64,
                                device=device),
            "text_lengths": torch.zeros((1,), dtype=torch.int64,
                                        device=device),
            "spk_emb": torch.as_tensor(spk_emb, dtype=torch.float32,
                                       device=device)[None]}
        if keep is not None:
            inputs["prenet_keep"] = keep.to(device)
        super().__init__(self._infer, inputs, graph)

    def _infer(self, text, text_lengths, spk_emb, prenet_keep=None):
        out = self.model.infer(text, text_lengths, global_condition=spk_emb,
                               max_decoder_steps=self.steps,
                               prenet_keep=prenet_keep)
        return out["mel_outputs_postnet"], out["lengths"]


def _vocoder(args, cfg, device):
    """(WaveFlow on ``device``, its sample rate) of the vocoder flags."""
    voc_cfg = Config.from_yaml(args.waveflow_config)
    voc = ConditionalWaveFlow(**inference_model_kwargs(
        voc_cfg.get("model", {})))
    load_checkpoint_params(voc, args.waveflow_checkpoint)
    return voc.to(device).eval(), voc_cfg.get("fs", cfg.fs)


def main(argv=None) -> dict:
    """Clone with ``argv`` (default: the command line); returns
    {"embedding", "embed_s", "capture_s", "sample_rate", "lines":
    [{utt_id, frames, samples, decode_s, vocoder_s, path}], "speech": the
    ``ClonedSpeech``}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--stat", type=Path, default=None)
    parser.add_argument("--ge2e-checkpoint", type=Path, required=True)
    parser.add_argument("--ref-wav", type=Path, required=True)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--text", type=Path, required=True,
                        help="lines: <utt_id> <pinyin syllables>")
    parser.add_argument("--waveflow-config", type=Path, default=None)
    parser.add_argument("--waveflow-checkpoint", type=Path, default=None)
    parser.add_argument("--output-dir", type=Path, default=Path("cloned"))
    parser.add_argument("--max-text-len", type=int, default=128)
    parser.add_argument("--max-decoder-steps", type=int, default=1000)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    vocab = {}
    with open(args.phones_dict, encoding="utf-8") as f:
        for line in f:
            sym, idx = line.split()
            vocab[sym] = int(idx)
    model_kwargs = inference_model_kwargs(cfg.get("model", {}))
    model_kwargs.setdefault("d_global_condition", 256)
    model = Tacotron2(vocab_size=len(vocab), **model_kwargs)
    load_checkpoint_params(model, args.checkpoint)
    model.to(device).eval()
    norm = ZScore(*np.load(args.stat)) if args.stat else None

    clock = Stopwatch(device)
    spk_emb = embed_reference(args.ref_wav, args.ge2e_checkpoint, device)
    embed_s = clock.seconds()
    clock = Stopwatch(device)
    speech = ClonedSpeech(model, spk_emb, args.max_text_len,
                          args.max_decoder_steps, device,
                          graph=device.type == "cuda")
    capture_s = clock.seconds()
    vocoder = fs = None
    if args.waveflow_checkpoint is not None:
        vocoder, fs = _vocoder(args, cfg, device)

    lexicon = generate_lexicon(with_tone=True, with_erhua=True)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    with open(args.text, encoding="utf-8") as f:
        sentences = [line.strip().split(maxsplit=1) for line in f
                     if line.strip()]
    for utt_id, pinyin in sentences:
        clock = Stopwatch(device)
        mel, lengths = speech(phone_ids(pinyin, lexicon, vocab))
        n = int(lengths[0])
        decode_s = clock.seconds()
        if n == 0:
            print(f"{utt_id}: decoded 0 frames, skipping")
            continue
        mel = mel[0, :n]
        if norm is not None:
            mel = norm.inverse(mel)
        record = {"utt_id": utt_id, "frames": n, "decode_s": decode_s,
                  "vocoder_s": None, "samples": None}
        if vocoder is None:
            out = args.output_dir / f"{utt_id}.npy"
            np.save(out, mel.float().cpu().numpy())
        else:
            clock = Stopwatch(device)
            with torch.no_grad():
                wav = vocoder.infer(mel[None].float(), torch.Generator(
                    device=device).manual_seed(NOISE_SEED))[0]
            wav = wav.cpu().numpy()
            record["vocoder_s"] = clock.seconds()
            record["samples"] = len(wav)
            out = args.output_dir / f"{utt_id}.wav"
            save_wav(out, wav, fs)
        record["path"] = str(out)
        lines.append(record)
        print(f"{utt_id}: {n} frames -> {out} (decode "
              f"{1e3 * decode_s:.1f} ms" + (
                  "" if record["vocoder_s"] is None else
                  f", vocoder {1e3 * record['vocoder_s']:.1f} ms") + ")")
    return {"embedding": spk_emb, "embed_s": embed_s, "capture_s": capture_s,
            "sample_rate": fs, "lines": lines, "speech": speech}


if __name__ == "__main__":
    main()
