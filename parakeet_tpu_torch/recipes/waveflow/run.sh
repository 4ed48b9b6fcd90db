#!/usr/bin/env bash
# WaveFlow recipe pipeline of the port: the twin of recipes/waveflow/run.sh,
# stage for stage, on the port's CLIs.
# Stages: 0 preprocess (PWGAN's wav->mel stage, as the JAX script runs),
# 1 train, 2 synthesize (the mels of MELS, default an empty $EXP/mels).
# Runs from any directory: relative paths are the caller's, CONF
# defaults to the recipe's YAML, and the repository goes on PYTHONPATH.
# DEVICE (default cuda) goes to every --device.
set -euo pipefail

root=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
cli=parakeet_tpu_torch.recipes.waveflow

stage=${1:-0}
stop_stage=${2:-100}
rootdir=${ROOTDIR:-data/wavs}
conf=${CONF:-$root/recipes/waveflow/conf/default.yaml}
dump=${DUMP:-dump}
exp=${EXP:-exp/default}
device=${DEVICE:-cuda}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  python -m parakeet_tpu_torch.recipes.pwgan.preprocess --rootdir "$rootdir" \
    --dumpdir "$dump" --config "$conf"
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  python -m $cli.train --config "$conf" \
    --train-metadata "$dump/metadata_train.jsonl" \
    --dev-metadata "$dump/metadata_dev.jsonl" \
    --output-dir "$exp" --device "$device"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  ckpt=$(ls -t "$exp"/checkpoints/*.npz | head -1)
  mkdir -p "$exp/mels"
  python -m $cli.synthesize --config "$conf" --checkpoint "$ckpt" \
    --input "${MELS:-$exp/mels}" --output "$exp/wavs" --device "$device"
fi
