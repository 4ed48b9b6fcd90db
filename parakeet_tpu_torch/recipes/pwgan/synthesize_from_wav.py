"""Copy-synthesis in the port: wav -> log-mel -> z-score -> Parallel
WaveGAN -> wav (counterpart of ``recipes/pwgan/synthesize_from_wav.py``;
reference: examples/GANVocoder/parallelwave_gan/baker/
synthesize_from_wav.py).

Each ``--input-wav`` is loaded at the YAML's rate, its log-mel extracted
on the host (the port's copy of ``audio/features.py::LogMelFBank``) and
z-scored with ``--stats`` (the normalize stage's ``feats_stats.npy``),
then cut or zero-padded to ``--max-frames`` frames and vocoded whole
(kernel K1 on the card with ``stack_impl: pallas``, eagerly) on the same
noise for every input (a generator seeded 0; the JAX CLI's fixed key
gives other numbers); the wav, cut to the input's frames, is written as
``<stem>_gen.wav``.  The sanity check of a trained vocoder: the output
should sound like the input.

TF32 is off.  Each input prints its frames and the host-clock times
(synchronised) of the mel and the vocoder; ``main`` returns them.

Usage:
  python -m parakeet_tpu_torch.recipes.pwgan.synthesize_from_wav \\
      --config recipes/pwgan/conf/default.yaml \\
      --checkpoint exp/checkpoints/snapshot_iter_N.npz \\
      --stats dump/feats_stats.npy --input-wav in.wav --output-dir wavs \\
      [--device cpu]
"""
import argparse
import time
from pathlib import Path

import numpy as np

from ...audio.codec import load_wav, save_wav
from ...audio.features import LogMelFBank
from ...training import Config
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..fastspeech2.synthesize_e2e import PaddedVocoder, build_vocoder
from ..synthesis import Stopwatch

__all__ = ["main"]


def main(argv=None) -> dict:
    """Copy-synthesize with ``argv`` (default: the command line); returns
    {"sample_rate", "lines": [{input, frames, samples, mel_s, vocoder_s,
    path, mel, wav}], "vocoder"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--stats", type=Path, required=True,
                        help="feats_stats.npy from the normalize stage")
    parser.add_argument("--input-wav", type=Path, required=True,
                        nargs="+", help="one or more waveforms")
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--max-frames", type=int, default=1024,
                        help="mel frames are padded to this static length")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = set_device(args.device)
    disable_tf32()

    cfg = Config.from_yaml(args.config)
    vocoder = PaddedVocoder(build_vocoder(args.config, args.checkpoint,
                                          device), args.max_frames)
    mel_extractor = LogMelFBank(sr=cfg.fs, n_fft=cfg.n_fft,
                                hop_length=cfg.n_shift,
                                win_length=cfg.win_length,
                                fmin=cfg.fmin, fmax=cfg.fmax,
                                n_mels=cfg.n_mels)
    arr = np.load(args.stats)
    mean, std = arr[0], np.maximum(arr[1], 1e-8)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for wav_path in args.input_wav:
        tic = time.perf_counter()
        wav, _ = load_wav(wav_path, sr=cfg.fs)
        mel = (mel_extractor.get_log_mel_fbank(wav) - mean) / std
        mel_s = time.perf_counter() - tic
        clock = Stopwatch(device)
        out_wav, n = vocoder(mel)
        vocoder_s = clock.seconds()
        out = args.output_dir / f"{Path(wav_path).stem}_gen.wav"
        save_wav(out, out_wav, cfg.fs)
        lines.append({"input": str(wav_path), "frames": n,
                      "samples": len(out_wav), "mel_s": mel_s,
                      "vocoder_s": vocoder_s, "path": str(out),
                      "mel": mel.astype(np.float32), "wav": out_wav})
        print(f"{wav_path} -> {out} ({n} frames; mel {1e3 * mel_s:.1f} ms, "
              f"vocoder {1e3 * vocoder_s:.1f} ms)")
    return {"sample_rate": cfg.fs, "lines": lines, "vocoder": vocoder}


if __name__ == "__main__":
    main()
