#!/usr/bin/env bash
# TransformerTTS recipe pipeline of the port: the twin of recipes/transformer_tts/run.sh,
# stage for stage, on the port's CLIs.
# Stages: 0 preprocess+normalize, 1 train, 2 synthesize.  Stage 0 runs
# FastSpeech2's preprocess and normalize, as the JAX script does (its
# durations are unused by the model), not recipes.transformer_tts.preprocess.
# Runs from any directory: relative paths are the caller's, CONF
# defaults to the recipe's YAML, and the repository goes on PYTHONPATH.
# DEVICE (default cuda) goes to every --device.
set -euo pipefail

root=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
cli=parakeet_tpu_torch.recipes.transformer_tts
fs2=parakeet_tpu_torch.recipes.fastspeech2

stage=${1:-0}
stop_stage=${2:-100}
rootdir=${ROOTDIR:-data/wavs}
durfile=${DURFILE:-data/durations.txt}
conf=${CONF:-$root/recipes/transformer_tts/conf/default.yaml}
dump=${DUMP:-dump}
exp=${EXP:-exp/default}
device=${DEVICE:-cuda}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  python -m $fs2.preprocess --rootdir "$rootdir" \
    --duration-file "$durfile" --dumpdir "$dump" --config "$conf"
  python -m $fs2.normalize --metadata "$dump/metadata_train.jsonl" \
    --dumpdir "$dump/norm/train" --phones-dict "$dump/phone_id_map.txt" \
    --stats-dir "$dump" --compute-stats
  python -m $fs2.normalize --metadata "$dump/metadata_dev.jsonl" \
    --dumpdir "$dump/norm/dev" --phones-dict "$dump/phone_id_map.txt" \
    --stats-dir "$dump"
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  python -m $cli.train --config "$conf" \
    --train-metadata "$dump/norm/train/metadata.jsonl" \
    --dev-metadata "$dump/norm/dev/metadata.jsonl" \
    --phones-dict "$dump/phone_id_map.txt" \
    --output-dir "$exp" --device "$device"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  ckpt=$(ls -t "$exp"/checkpoints/*.npz | head -1)
  python -m $cli.synthesize --config "$conf" --checkpoint "$ckpt" \
    --stat "$dump/speech_stats.npy" \
    --test-metadata "$dump/norm/dev/metadata.jsonl" \
    --phones-dict "$dump/phone_id_map.txt" \
    --output-dir "$exp/wavs" --device "$device"
fi
