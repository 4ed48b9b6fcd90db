"""Batched serving in the port: text lines -> ``TTSEngine`` -> wavs
(counterpart of ``tools/serve.py``).

The batch-scheduling twin of ``synthesize_e2e.py`` (one utterance a
step): every line is frontended up front (``frontend/cli.py::
build_text_to_ids``), each request seeded with the CRC-32 of its utt_id,
then the requests are grouped onto the engine's (text, batch) bucket
grid (``serving.py``; the batch buckets 1, 2, 4, ... up to
``--batch-size``) and synthesized FastSpeech2 -> Parallel WaveGAN (kernel
K1 on the card) a chunk at a time.  On the card each grid point is one
CUDA graph, captured at its first use, or by ``--warmup`` over the whole
grid before the timed run.  A request longer than the largest text bucket
is split at the phone map's pause tokens and its wavs stitched
(``--overflow split``), truncated, or refused.  Without a vocoder the
mel's pseudo-inverse and Griffin-Lim make each wav.

TF32 is off.  It prints the audio seconds a second of the timed run;
``main`` returns them with the engine and its results.

Usage:
  python -m parakeet_tpu_torch.recipes.fastspeech2.serve \\
      --fastspeech2-config recipes/fastspeech2/conf/default.yaml \\
      --fastspeech2-checkpoint exp/default/checkpoints/snapshot_iter_N.npz \\
      --pwg-config recipes/pwgan/conf/default.yaml \\
      --pwg-checkpoint exp/pwg/checkpoints/snapshot_iter_M.npz \\
      --phones-dict dump/phone_id_map.txt --text sentences.txt \\
      --output-dir wavs [--lang zh|en] [--batch-size 8] [--warmup] \\
      [--device cpu]
"""
import argparse
import time
import zlib
from pathlib import Path

import numpy as np

from ...audio.codec import save_wav
from ...audio.spectrum import logmel_to_wav
from ...frontend.cli import build_text_to_ids
from ...ops.normalizer import ZScore
from ...serving import Request, TTSEngine
from ...utils.device import add_device_arg, disable_tf32, set_device
from ..synthesis import Stopwatch
from .synthesize_e2e import build_acoustic_model, build_vocoder

__all__ = ["main", "PAUSE_TOKENS"]

# pause phones: preferred boundaries when a long request must be split
PAUSE_TOKENS = frozenset({"sp", "sil", "<sp>", "sp1", "sil0", "pau"})


def main(argv=None) -> dict:
    """Serve with ``argv`` (default: the command line); returns
    {"engine", "requests", "results", "frontend_s" (every line's, on the
    host), "warmup_s", "elapsed_s", "audio_s", "sample_rate"}."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=__doc__.split("\n\n")[-1],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--fastspeech2-config", type=Path, required=True)
    parser.add_argument("--fastspeech2-checkpoint", type=Path,
                        required=True)
    parser.add_argument("--fastspeech2-stat", type=Path, default=None)
    parser.add_argument("--pwg-config", type=Path, default=None)
    parser.add_argument("--pwg-checkpoint", type=Path, default=None)
    parser.add_argument("--pwg-stat", type=Path, default=None)
    parser.add_argument("--phones-dict", type=Path, required=True)
    parser.add_argument("--text", type=Path, required=True,
                        help="lines: <utt_id> <sentence>")
    parser.add_argument("--output-dir", type=Path, default=Path("wavs"))
    parser.add_argument("--lang", default="zh",
                        choices=("zh", "en", "en-char"))
    parser.add_argument("--speaker-dict", type=Path, default=None)
    parser.add_argument("--spk-id", type=int, default=0)
    parser.add_argument("--text-buckets", type=int, nargs="+",
                        default=(32, 64, 128))
    parser.add_argument("--batch-size", type=int, default=8,
                        help="largest batch bucket (grid: 1, 2, ..., N "
                             "powers of two up to this)")
    parser.add_argument("--frames-per-token", type=int, default=8)
    parser.add_argument("--min-duration", type=int, default=1)
    parser.add_argument("--warmup", action="store_true",
                        help="build (capture) the whole bucket grid before "
                             "the timed run")
    parser.add_argument("--overflow", default="split",
                        choices=("split", "truncate", "error"),
                        help="requests longer than the largest text "
                             "bucket: split at pause tokens and stitch "
                             "the wavs (default), truncate, or error")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if (args.pwg_checkpoint is None) != (args.pwg_config is None):
        parser.error("--pwg-config and --pwg-checkpoint go together "
                     "(omit both for the Griffin-Lim fallback)")
    device = set_device(args.device)
    disable_tf32()

    am, am_cfg = build_acoustic_model(
        args.fastspeech2_config, args.fastspeech2_checkpoint,
        args.phones_dict, args.speaker_dict, device)
    voc = None
    if args.pwg_checkpoint is not None:
        voc = build_vocoder(args.pwg_config, args.pwg_checkpoint, device)

    with open(args.phones_dict, encoding="utf-8") as f:
        split_ids = [int(i) for p, i in (ln.split() for ln in f)
                     if p in PAUSE_TOKENS]
    batch_buckets = [b for b in (1, 2, 4, 8, 16, 32, 64)
                     if b < args.batch_size] + [args.batch_size]
    engine = TTSEngine(
        am, voc=voc,
        am_norm=(ZScore(*np.load(args.fastspeech2_stat))
                 if args.fastspeech2_stat else None),
        voc_norm=(ZScore(*np.load(args.pwg_stat))
                  if args.pwg_stat else None),
        text_buckets=tuple(args.text_buckets),
        batch_buckets=tuple(sorted(set(batch_buckets))),
        frames_per_token=args.frames_per_token,
        min_duration=args.min_duration,
        multi_speaker=args.speaker_dict is not None,
        overflow=args.overflow, split_ids=split_ids)

    get_ids = build_text_to_ids(args.lang, args.phones_dict)
    tic = time.perf_counter()
    requests = []
    cap = max(args.text_buckets)
    with open(args.text, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) != 2:
                continue
            utt_id, sentence = parts
            ids = get_ids(sentence)
            if not ids:
                print(f"skip {utt_id}: empty phone sequence")
                continue
            if len(ids) > cap:
                action = {"split": "splitting at pause tokens",
                          "truncate": "TRUNCATING to the bucket",
                          "error": "will raise"}[args.overflow]
                print(f"warn {utt_id}: {len(ids)} phones exceeds the "
                      f"largest text bucket ({cap}); {action}")
            requests.append(Request(ids=ids, utt_id=utt_id,
                                    seed=zlib.crc32(utt_id.encode()),
                                    spk_id=args.spk_id))
    if not requests:
        raise SystemExit("no synthesizable lines in --text")
    frontend_s = time.perf_counter() - tic

    warmup_s = None
    if args.warmup:
        tic = time.perf_counter()
        n = engine.warmup()
        warmup_s = time.perf_counter() - tic
        print(f"warmup: {n} programs built in {warmup_s:.1f} s")

    clock = Stopwatch(device)
    results = engine.synthesize(requests)
    elapsed = clock.seconds()

    args.output_dir.mkdir(parents=True, exist_ok=True)
    fs = am_cfg.fs
    total_audio = 0.0
    for res in results:
        if res.wav is not None:
            wav = res.wav
        else:
            wav = logmel_to_wav(res.mel, am_cfg.fs, am_cfg.n_fft,
                                am_cfg.n_shift, am_cfg.win_length,
                                fmin=am_cfg.fmin, fmax=am_cfg.fmax)
        save_wav(args.output_dir / f"{res.utt_id}.wav",
                 np.asarray(wav).reshape(-1), fs)
        total_audio += len(wav) / fs
    print(f"{len(results)} utterances, {total_audio:.1f} s audio in "
          f"{elapsed:.2f} s wall ({total_audio / elapsed:.1f} audio-s/s; "
          f"{engine.compiled_programs} programs)")
    return {"engine": engine, "requests": requests, "results": results,
            "frontend_s": frontend_s, "warmup_s": warmup_s,
            "elapsed_s": elapsed,
            "audio_s": total_audio, "sample_rate": fs}


if __name__ == "__main__":
    main()
