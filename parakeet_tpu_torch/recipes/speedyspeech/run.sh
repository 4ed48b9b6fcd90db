#!/usr/bin/env bash
# SpeedySpeech recipe pipeline of the port: the twin of
# recipes/speedyspeech/run.sh, stage for stage, on the port's CLIs.
# Stages: 0 preprocess, 1 normalize, 2 train, 3 synthesize_e2e (+export,
# torch.export programs), 4 deploy from the exported programs.
# Runs from any directory: relative paths are the caller's, CONF and
# PWG_CONF default to the recipes' YAMLs, and the repository goes on
# PYTHONPATH.  DEVICE (default cuda) goes to every --device; stage 4
# needs the device that stage 3 exported for.
set -euo pipefail

root=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
cli=parakeet_tpu_torch.recipes.speedyspeech

stage=${1:-0}
stop_stage=${2:-100}
rootdir=${ROOTDIR:-data/wavs}
durfile=${DURFILE:-data/durations.txt}
conf=${CONF:-$root/recipes/speedyspeech/conf/default.yaml}
dump=${DUMP:-dump}
exp=${EXP:-exp/default}
device=${DEVICE:-cuda}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  python -m $cli.preprocess --rootdir "$rootdir" --duration-file "$durfile" \
    --dumpdir "$dump" --config "$conf" --num-cpu 8
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  python -m $cli.normalize --metadata "$dump/metadata_train.jsonl" \
    --dumpdir "$dump/norm/train" --stats-dir "$dump" --compute-stats
  python -m $cli.normalize --metadata "$dump/metadata_dev.jsonl" \
    --dumpdir "$dump/norm/dev" --stats-dir "$dump"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  python -m $cli.train --config "$conf" \
    --train-metadata "$dump/norm/train/metadata.jsonl" \
    --dev-metadata "$dump/norm/dev/metadata.jsonl" \
    --phones-dict "$dump/phone_id_map.txt" \
    --tones-dict "$dump/tone_id_map.txt" \
    --output-dir "$exp" --device "$device"
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  ckpt=$(ls -t "$exp"/checkpoints/*.npz | head -1)
  python -m $cli.synthesize_e2e --config "$conf" --checkpoint "$ckpt" \
    --stat "$dump/feats_stats.npy" \
    --pwg-config "${PWG_CONF:-$root/recipes/pwgan/conf/default.yaml}" \
    --pwg-checkpoint "${PWG_CKPT:?set PWG_CKPT}" \
    --phones-dict "$dump/phone_id_map.txt" \
    --tones-dict "$dump/tone_id_map.txt" \
    --text "${TEXT:-sentences.txt}" --output-dir "$exp/wavs" \
    --export-dir "$exp/exported" --device "$device"
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  python -m $cli.inference --export-dir "$exp/exported" \
    --phones-dict "$dump/phone_id_map.txt" \
    --tones-dict "$dump/tone_id_map.txt" \
    --text "${TEXT:-sentences.txt}" --output-dir "$exp/wavs_deployed" \
    --device "$device"
fi
