#!/usr/bin/env bash
# Voice-cloning pipeline of the port: the twin of
# recipes/tacotron2_aishell3/run.sh, on the port's CLIs.
# Stages: 0 mel extraction, 1 GE2E embeddings, 2 transcript G2P,
# 3 conditioned training, 4 voice cloning.
# Stage 1 differs from the JAX script's, which runs the GE2E encoder on
# stage 0's mels: those are Tacotron2's 80 bands at 22.05 kHz, and the
# encoder takes 40 bands at 16 kHz, so that stage fails there.  Here stage
# 1 first computes GE2E's own mels of the same wavs (ge2e.preprocess,
# every utterance kept: --min-frames 0) into $DUMP/ge2e_mel, then embeds
# those into $DUMP/embed, the order of the port's README.  The other
# stages are the JAX script's.
# Runs from any directory: relative paths are the caller's, the recipe's
# YAML is read from the repository, and the repository goes on
# PYTHONPATH.  DEVICE (default cuda) goes to every --device.
set -euo pipefail

root=$(cd "$(dirname "${BASH_SOURCE[0]}")/../../.." && pwd)
export PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}"
cli=parakeet_tpu_torch.recipes.tacotron2_aishell3
ge2e=parakeet_tpu_torch.recipes.ge2e
conf=$root/recipes/tacotron2_aishell3/conf/default.yaml

stage=${1:-0}
stop_stage=${2:-100}
wavroot=${WAVROOT:-data_aishell3/train/wav}
label=${LABEL:-data_aishell3/train/label_train-set.txt}
dump=${DUMP:-dump}
exp=${EXP:-exp/vc}
ge2e_ckpt=${GE2E_CKPT:?set GE2E_CKPT to a trained GE2E checkpoint}
device=${DEVICE:-cuda}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  python -m $cli.extract_mel --input "$wavroot" --output "$dump/mel"
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  python -m $ge2e.preprocess --input "$wavroot" --output "$dump/ge2e_mel" \
    --min-frames 0
  python -m $ge2e.inference --checkpoint "$ge2e_ckpt" \
    --input "$dump/ge2e_mel" --output "$dump/embed" --device "$device"
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  python -m $cli.chinese_g2p --transcription "$label" \
    --mel-root "$dump/mel" --embed-root "$dump/embed" --output-dir "$dump"
  head -100 "$dump/metadata.jsonl" > "$dump/metadata_dev.jsonl"
  tail -n +101 "$dump/metadata.jsonl" > "$dump/metadata_train.jsonl"
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  python -m $cli.train --config "$conf" \
    --train-metadata "$dump/metadata_train.jsonl" \
    --dev-metadata "$dump/metadata_dev.jsonl" \
    --phones-dict "$dump/phone_id_map.txt" --output-dir "$exp" \
    --device "$device"
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  ckpt=$(ls -t "$exp"/checkpoints/*.npz | head -1)
  python -m $cli.voice_cloning --config "$conf" --checkpoint "$ckpt" \
    --ge2e-checkpoint "$ge2e_ckpt" --ref-wav "${REF_WAV:?set REF_WAV}" \
    --phones-dict "$dump/phone_id_map.txt" \
    --text "${TEXT:-sentences_pinyin.txt}" --output-dir "$exp/cloned" \
    --device "$device"
fi
