#!/usr/bin/env bash
# GE2E speaker-encoder pipeline of the port: the twin of
# recipes/ge2e/run.sh, stage for stage, on the port's CLIs.
# Stages: 0 preprocess (VAD + mel partials), 1 train, 2 export embeddings.
# Runs from any directory: relative paths are the caller's, and the
# repository goes on PYTHONPATH.  DEVICE (default cuda) goes to every
# --device.
set -euo pipefail

root=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
cli=parakeet_tpu_torch.recipes.ge2e

stage=${1:-0}
stop_stage=${2:-100}
rootdir=${ROOTDIR:-data/speakers}
dump=${DUMP:-dump/ge2e_mels}
exp=${EXP:-exp/ge2e}
device=${DEVICE:-cuda}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  python -m $cli.preprocess --input "$rootdir" --output "$dump"
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  python -m $cli.train --data-root "$dump" --output-dir "$exp" \
    --device "$device"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  ckpt=$(ls -t "$exp"/checkpoints/*.npz | head -1)
  python -m $cli.inference --checkpoint "$ckpt" --input "$dump" \
    --output "${EMBED_OUT:-dump/ge2e_embeds}" --device "$device"
fi
