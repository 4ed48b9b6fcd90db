#!/usr/bin/env bash
# Parallel WaveGAN recipe pipeline of the port: the twin of
# recipes/pwgan/run.sh, stage for stage, on the port's CLIs.
# Stages: 0 preprocess, 1 stats+normalize, 2 train, 3 synthesize.
# Runs from any directory: relative paths are the caller's, CONF
# defaults to the recipe's YAML, and the repository goes on PYTHONPATH.
# DEVICE (default cuda) goes to every --device.
set -euo pipefail

root=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
cli=parakeet_tpu_torch.recipes.pwgan

stage=${1:-0}
stop_stage=${2:-100}
rootdir=${ROOTDIR:-data/wavs}
conf=${CONF:-$root/recipes/pwgan/conf/default.yaml}
dump=${DUMP:-dump}
exp=${EXP:-exp/default}
durfile=${DURFILE:-}   # optional MFA durations.txt enables --cut-sil
device=${DEVICE:-cuda}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  if [ -n "$durfile" ]; then
    python -m $cli.preprocess --rootdir "$rootdir" --dumpdir "$dump/raw" \
      --config "$conf" --dur-file "$durfile" --cut-sil
  else
    python -m $cli.preprocess --rootdir "$rootdir" --dumpdir "$dump/raw" \
      --config "$conf"
  fi
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  # dev reuses the train split's statistics
  python -m $cli.normalize --metadata "$dump/raw/metadata_train.jsonl" \
    --dumpdir "$dump/train/norm" --stats "$dump/feats_stats.npy" \
    --compute-stats
  python -m $cli.normalize --metadata "$dump/raw/metadata_dev.jsonl" \
    --dumpdir "$dump/dev/norm" --stats "$dump/feats_stats.npy"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  python -m $cli.train --config "$conf" \
    --train-metadata "$dump/train/norm/metadata.jsonl" \
    --dev-metadata "$dump/dev/norm/metadata.jsonl" \
    --output-dir "$exp" --device "$device"
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  ckpt=$(ls -t "$exp"/checkpoints/*.npz | head -1)
  python -m $cli.synthesize --config "$conf" --checkpoint "$ckpt" \
    --test-metadata "$dump/dev/norm/metadata.jsonl" \
    --output-dir "$exp/wavs" --device "$device"
fi
