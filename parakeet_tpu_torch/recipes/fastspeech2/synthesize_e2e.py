"""End-to-end synthesis in the port: text -> frontend -> FastSpeech2 ->
Parallel WaveGAN -> wav (counterpart of
``recipes/fastspeech2/synthesize_e2e.py``; reference:
examples/fastspeech2/baker/synthesize_e2e.py:32-90).

1. Each line of ``--text`` (``<utt_id> <sentence>``) becomes phone ids
   through the text frontend of ``--lang`` (``frontend/cli.py::
   build_text_to_ids`` with ``--phones-dict``), cut to ``--max-text-len``.
2. ``FastSpeech2.inference`` reads them zero-padded at the static shape
   (1, ``--max-text-len``) with ``--max-frames`` of decoder capacity and
   each token's duration floored at ``--min-duration`` (and the speaker
   ``--spk-id`` with ``--speaker-dict``): on the card one CUDA graph,
   captured once and replayed for every line, as the JAX CLI jits it
   once.  The mel is cut to the predicted frames and ``--fastspeech2-stat``
   undoes its normalisation.
3. With ``--pwg-checkpoint`` the mel (``--pwg-stat`` normalised) goes
   through the Parallel WaveGAN generator, whose residual stack is kernel
   K1 on the card (the YAML's ``stack_impl: pallas``), eagerly on each
   line's frames; its noise comes from a generator seeded with the CRC-32
   of the utt_id, the integer the JAX CLI seeds its key with (the streams
   differ).  ``--streaming-chunk-frames`` vocodes in windows of that many
   frames with the same samples.  Without a vocoder, the mel's
   pseudo-inverse and Griffin-Lim make the wav.

With ``--export-dir`` (and a vocoder) the two programs that JAX's
``jax.export`` writes are written first through ``torch.export``, for
``inference.py``: ``fastspeech2.pt2``, the acoustic model at (1,
``--max-text-len``) -> (the mel in the vocoder's domain, both statistics
and the speaker baked in; its frames), and ``pwgan.pt2``, the vocoder at
(1, ``--max-frames``, n_mels) with noise (1, ``--max-frames`` * hop, 1)
-> wav.  Each records the device it was made for; an export made on the
card holds K1's operator (``ops/kernels/pwg_stack.py``), one made on the
CPU its plain version.

TF32 is off.  Each line prints its frames and the host-clock times
(synchronised) of the acoustic model and the vocoder; ``main`` returns
them with the frontend's.  Checkpoints are any the JAX package or the
port writes (``bridge.load_checkpoint_params``).  Not ported: ``--sp``
above 1 (ROADMAP queue 1, item 18), refused.

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.synthesize_e2e \\
      --fastspeech2-config recipes/fastspeech2/conf/default.yaml \\
      --fastspeech2-checkpoint exp/default/checkpoints/snapshot_iter_N.npz \\
      --pwg-config recipes/pwgan/conf/default.yaml \\
      --pwg-checkpoint exp/pwg/checkpoints/snapshot_iter_M.npz \\
      --phones-dict dump/phone_id_map.txt --text sentences.txt \\
      --output-dir wavs [--lang zh|en|en-char] [--device cpu]
"""
import argparse
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...audio.codec import save_wav
from ...audio.spectrum import logmel_to_wav
from ...bridge import load_checkpoint_params
from ...frontend.cli import build_text_to_ids
from ...models import FastSpeech2, PWGGenerator, pwg_inference
from ...models.parallel_wavegan import pwg_streaming_inference
from ...ops.normalizer import ZScore
from ...training import Config, inference_model_kwargs
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..common import count_lines
from ..synthesis import (Stopwatch, TextProgram, add_deploy_args,
                         read_sentences, refuse_unported, save_export)

__all__ = ["main", "build_acoustic_model", "build_vocoder", "vocode",
           "acoustic_program",
           "PaddedVocoder", "VocoderProgram", "export_programs"]


def build_vocoder(config, checkpoint, device) -> PWGGenerator:
    """The Parallel WaveGAN generator of a YAML's ``generator_params`` with
    a checkpoint's weights, on ``device``."""
    cfg = Config.from_yaml(config)
    voc = PWGGenerator(**inference_model_kwargs(
        cfg.get("generator_params", {})))
    load_checkpoint_params(voc, checkpoint)
    return voc.to(device).eval().requires_grad_(False)


def build_acoustic_model(config, checkpoint, phones_dict, speaker_dict,
                         device):
    """(the YAML's FastSpeech2 with a checkpoint's weights on ``device``,
    the YAML's ``Config``): idim the line count of ``phones_dict``; with
    ``speaker_dict`` its line count of speakers, embedded 256 wide unless
    the YAML says otherwise."""
    cfg = Config.from_yaml(config)
    overrides = dict(cfg.get("model", {}))
    if speaker_dict is not None:
        overrides.setdefault("num_speakers", count_lines(speaker_dict))
        overrides.setdefault("spk_embed_dim", 256)
    am = FastSpeech2(idim=count_lines(phones_dict), odim=cfg.n_mels,
                     **inference_model_kwargs(overrides))
    load_checkpoint_params(am, checkpoint)
    return am.to(device).eval().requires_grad_(False), cfg


def acoustic_program(am: FastSpeech2, max_text_len: int, max_frames: int,
                     min_duration: int, device: torch.device,
                     spk_id: Optional[int] = None) -> TextProgram:
    """``FastSpeech2.inference`` at (1, ``max_text_len``) with
    ``max_frames`` of capacity and durations floored at ``min_duration``,
    returning (after_outs, frame_lengths): one CUDA graph on the card,
    else eager.  With ``spk_id`` its input ``spk_id`` (1,) holds the
    speaker, which the caller may refill between lines."""
    inputs = {"text": torch.zeros((1, max_text_len), dtype=torch.int64,
                                  device=device),
              "text_lengths": torch.zeros((1,), dtype=torch.int64,
                                          device=device)}
    if spk_id is not None:
        inputs["spk_id"] = torch.full((1,), spk_id, dtype=torch.int64,
                                      device=device)

    def infer(text, text_lengths, spk_id=None):
        out = am.inference(text, text_lengths, max_frames=max_frames,
                           min_duration=min_duration, spk_id=spk_id)
        return out["after_outs"], out["frame_lengths"]

    return TextProgram(infer, inputs, graph=device.type == "cuda")


def vocode(voc, mel, seed: int, chunk_frames: int = 0) -> torch.Tensor:
    """``mel`` (T, n_mels) -> wav (T * hop,) with noise from a generator on
    the mel's device seeded ``seed``; in windows of ``chunk_frames`` when
    it is positive."""
    rng = torch.Generator(device=mel.device).manual_seed(seed)
    with torch.no_grad():
        if chunk_frames > 0:
            return pwg_streaming_inference(voc, mel, rng=rng,
                                           chunk_frames=chunk_frames)
        return pwg_inference(voc, mel, rng=rng)


class PaddedVocoder:
    """``voc`` on mels cut or zero-padded to ``max_frames`` frames (the
    JAX CLIs' static length) and one noise, drawn once from a generator
    on its device seeded ``seed``: ``(mel (T, n_mels) numpy) -> (wav
    (min(T, max_frames) * hop,) float32 numpy, frames)``."""

    def __init__(self, voc: PWGGenerator, max_frames: int, seed: int = 0):
        self.voc, self.max_frames = voc, max_frames
        self.hop = voc.upsample_factor
        self.device = next(voc.parameters()).device
        self.noise = torch.randn(
            (1, max_frames * self.hop, 1), device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(seed))

    def __call__(self, mel: np.ndarray):
        n = min(mel.shape[0], self.max_frames)
        padded = np.zeros((self.max_frames, mel.shape[1]), np.float32)
        padded[:n] = mel[:n]
        with torch.no_grad():
            wav = pwg_inference(self.voc,
                                torch.from_numpy(padded).to(self.device),
                                noise=self.noise)
        return wav[:n * self.hop].float().cpu().numpy(), n


class VocoderProgram(torch.nn.Module):
    """The program that ``pwgan.pt2`` holds: mel (B, T, n_mels) and noise
    (B, T * hop, 1) -> wav (B, T * hop), ``pwg_inference``."""

    def __init__(self, voc: PWGGenerator):
        super().__init__()
        self.voc = voc

    def forward(self, mel, noise):
        return pwg_inference(self.voc, mel, noise=noise)


class AcousticProgram(torch.nn.Module):
    """The program that ``fastspeech2.pt2`` holds: (text (1, L), text
    lengths (1,)) -> (after_outs in the vocoder's domain (1, max_frames,
    n_mels), frame lengths (1,)), with the speaker (or None) and the
    statistics ((mu, sigma) tensors or None) held as buffers."""

    def __init__(self, am: FastSpeech2, max_frames: int, min_duration: int,
                 spk_id=None, am_stats=None, voc_stats=None):
        super().__init__()
        self.am, self.max_frames = am, max_frames
        self.min_duration = min_duration
        self.register_buffer("spk_id", spk_id)
        for name, stats in (("am_stats", am_stats), ("voc_stats", voc_stats)):
            self.register_buffer(name, None if stats is None
                                 else torch.stack(stats))

    def forward(self, text, text_lengths):
        out = self.am.inference(text, text_lengths,
                                max_frames=self.max_frames,
                                min_duration=self.min_duration,
                                spk_id=self.spk_id)
        mel = out["after_outs"]
        if self.am_stats is not None:
            mel = ZScore(*self.am_stats).inverse(mel)
        if self.voc_stats is not None:
            mel = ZScore(*self.voc_stats).transform(mel)
        return mel, out["frame_lengths"]


def export_programs(export_dir: Path, am_name: str, am_program, am_inputs,
                    voc: PWGGenerator, max_frames: int, n_mels: int,
                    device: torch.device) -> float:
    """Export ``am_program`` on ``am_inputs`` (static (1, L) int64 text
    buffers) and the vocoder at (1, ``max_frames``, ``n_mels``) through
    ``torch.export``, and save them as ``<am_name>.pt2`` and
    ``pwgan.pt2`` under ``export_dir`` with their records; returns the
    seconds it took."""
    tic = time.perf_counter()
    export_dir.mkdir(parents=True, exist_ok=True)
    hop = voc.upsample_factor
    am_ep = torch.export.export(am_program, tuple(am_inputs), strict=False)
    voc_ep = torch.export.export(
        VocoderProgram(voc), (torch.zeros((1, max_frames, n_mels),
                                          device=device),
                              torch.zeros((1, max_frames * hop, 1),
                                          device=device)), strict=False)
    save_export(export_dir / f"{am_name}.pt2", am_ep, device,
                program=am_name, max_text_len=am_inputs[0].shape[1],
                max_frames=max_frames, n_mels=n_mels)
    save_export(export_dir / "pwgan.pt2", voc_ep, device, program="pwgan",
                max_frames=max_frames, n_mels=n_mels, hop=hop)
    return time.perf_counter() - tic


def main(argv=None) -> dict:
    """Synthesize with ``argv`` (default: the command line); returns
    {"capture_s", "export_s" (None without ``--export-dir``),
    "sample_rate", "lines": [{utt_id, ids, frames, samples, frontend_s,
    am_s, vocoder_s, path, mel, wav}], "program": the ``TextProgram``}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--fastspeech2-config", type=Path, required=True)
    parser.add_argument("--fastspeech2-checkpoint", type=Path, required=True)
    parser.add_argument("--fastspeech2-stat", type=Path, default=None,
                        help="speech_stats.npy (mean/std) for denorm")
    parser.add_argument("--pwg-config", type=Path, default=None)
    parser.add_argument("--pwg-checkpoint", type=Path, default=None)
    parser.add_argument("--pwg-stat", type=Path, default=None)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--text", type=Path, required=True,
                        help="lines: <utt_id> <sentence>")
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--lang", default="zh",
                        choices=("zh", "en", "en-char"))
    parser.add_argument("--speaker-dict", type=Path, default=None,
                        help="speaker_id_map.txt of a multi-speaker model")
    parser.add_argument("--spk-id", type=int, default=0)
    parser.add_argument("--max-text-len", type=int, default=128)
    parser.add_argument("--max-frames", type=int, default=1024,
                        help="decoder frame capacity")
    parser.add_argument("--min-duration", type=int, default=1,
                        help="floor of each token's predicted duration")
    parser.add_argument("--streaming-chunk-frames", type=int, default=0,
                        help="vocode in windows of this many frames (the "
                             "same samples); 0 = one shot")
    add_deploy_args(parser)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if (args.pwg_checkpoint is None) != (args.pwg_config is None):
        parser.error("--pwg-config and --pwg-checkpoint must be given "
                     "together (omit both for the Griffin-Lim fallback)")
    refuse_unported(args)
    if args.export_dir is not None and args.pwg_checkpoint is None:
        raise SystemExit("--export-dir requires --pwg-checkpoint")
    device = set_device(args.device)
    disable_tf32()

    am, am_cfg = build_acoustic_model(
        args.fastspeech2_config, args.fastspeech2_checkpoint,
        args.phones_dict, args.speaker_dict, device)
    voc = None
    if args.pwg_checkpoint is not None:
        voc = build_vocoder(args.pwg_config, args.pwg_checkpoint, device)
    am_norm = (ZScore(*np.load(args.fastspeech2_stat)).to(device)
               if args.fastspeech2_stat else None)
    voc_norm = (ZScore(*np.load(args.pwg_stat)).to(device)
                if args.pwg_stat else None)
    get_ids = build_text_to_ids(args.lang, args.phones_dict)

    clock = Stopwatch(device)
    program = acoustic_program(am, args.max_text_len, args.max_frames,
                               args.min_duration, device,
                               None if args.speaker_dict is None
                               else args.spk_id)
    capture_s = clock.seconds()

    export_s = None
    if args.export_dir is not None:
        inputs = program.inputs
        am_program = AcousticProgram(
            am, args.max_frames, args.min_duration, inputs.get("spk_id"),
            None if am_norm is None else (am_norm.mu, am_norm.sigma),
            None if voc_norm is None else (voc_norm.mu, voc_norm.sigma))
        export_s = export_programs(
            args.export_dir, "fastspeech2", am_program,
            (inputs["text"], inputs["text_lengths"]), voc, args.max_frames,
            am_cfg.n_mels, device)
        print(f"exported fastspeech2.pt2 and pwgan.pt2 for {device.type} to "
              f"{args.export_dir} in {export_s:.2f} s")

    fs = am_cfg.fs
    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for utt_id, sentence in read_sentences(args.text):
        tic = time.perf_counter()
        ids = get_ids(sentence)[:args.max_text_len]
        frontend_s = time.perf_counter() - tic
        if not ids:
            print(f"skip {utt_id}: empty phone sequence")
            continue
        clock = Stopwatch(device)
        mel, frames = program(ids)
        n = int(frames[0])
        am_s = clock.seconds()
        if n == 0:
            print(f"skip {utt_id}: the model predicted 0 frames")
            continue
        mel = mel[0, :n]
        if am_norm is not None:
            mel = am_norm.inverse(mel)
        record = {"utt_id": utt_id, "ids": ids, "frames": n,
                  "frontend_s": frontend_s, "am_s": am_s, "vocoder_s": None,
                  "mel": mel.float().cpu().numpy()}
        if voc is None:
            wav = logmel_to_wav(record["mel"], am_cfg.fs, am_cfg.n_fft,
                                am_cfg.n_shift, am_cfg.win_length,
                                fmin=am_cfg.fmin, fmax=am_cfg.fmax)
        else:
            clock = Stopwatch(device)
            voc_in = mel if voc_norm is None else voc_norm.transform(mel)
            wav = vocode(voc, voc_in, zlib.crc32(utt_id.encode()),
                         args.streaming_chunk_frames)
            wav = wav.float().cpu().numpy()
            record["vocoder_s"] = clock.seconds()
        record["wav"] = wav = np.asarray(wav).reshape(-1)
        record["samples"] = len(wav)
        out = args.output_dir / f"{utt_id}.wav"
        save_wav(out, wav, fs)
        record["path"] = str(out)
        lines.append(record)
        print(f"{utt_id}: {n} frames, {len(wav) / fs:.2f} s -> {out} (AM "
              f"{1e3 * am_s:.1f} ms" + (
                  "" if record["vocoder_s"] is None else
                  f", vocoder {1e3 * record['vocoder_s']:.1f} ms") + ")")
    return {"capture_s": capture_s, "export_s": export_s, "sample_rate": fs,
            "lines": lines, "program": program}


if __name__ == "__main__":
    main()
