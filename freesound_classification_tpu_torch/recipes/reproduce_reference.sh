#!/usr/bin/env bash
# The published FSDKaggle2019 recipe end to end on the PyTorch port: the
# counterpart of scripts/reproduce_reference.sh, step for step and flag for
# flag, through the port's CLIs (python -m freesound_classification_tpu_torch
# .cli.*), on the card by default. Reports lwlrap against the reference.
#
# Usage:
#   DATA_DIR=/path/to/fsdkaggle2019 \
#     bash freesound_classification_tpu_torch/recipes/reproduce_reference.sh
#
# Expects under $DATA_DIR (the Kaggle layout the reference uses):
#   train_curated.csv  train_curated/   train_noisy.csv  train_noisy/
#   test/              sample_submission.csv
#
# Steps: 0 class map; 1 curated 5-fold 2d CNN with augmentations, then its
# OOF report; 2 score the noisy set with it and keep the top 1000 by
# label-ranking agreement; 3 curated + relabelled noisy round, then its
# report; 4 linear blend of the two experiments.
#
# Optional env:
#   EPOCHS=100           reference augmented-recipe epochs (lower to smoke)
#   NOISY_EPOCHS=150     reference noisy-round epochs
#   BATCH_SIZE=20        reference batch size (lower for smoke datasets
#                        whose folds hold fewer than 20 clips per bucket)
#   DEVICE=cuda          cuda|cpu
#   FOLD_PARALLEL=1      train all 5 folds as one stacked model on the card
#                        (set 0 for the reference's sequential fold loop)
#   REFERENCE_LWLRAP=x.y a reference-run global OOF lwlrap to diff against
#   REFERENCE_OOF_DIR=   a reference experiment's predictions/ dir (val_preds
#                        CSVs) for a per-class lwlrap comparison
#   SKIP_NOISY=1         stop after the curated stage
#   WORK=<repo>/parity_run  working directory (class map, experiments/,
#                        predictions/)
#   PY=python            the interpreter
set -euo pipefail

DATA_DIR=${DATA_DIR:?set DATA_DIR to the FSDKaggle2019 root}
EPOCHS=${EPOCHS:-100}
NOISY_EPOCHS=${NOISY_EPOCHS:-150}
BATCH_SIZE=${BATCH_SIZE:-20}
DEVICE=${DEVICE:-cuda}
FOLD_PARALLEL=${FOLD_PARALLEL:-0}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
WORK=${WORK:-"$REPO/parity_run"}
mkdir -p "$WORK/predictions"
cd "$WORK"

PY=${PY:-python}
CLI=freesound_classification_tpu_torch.cli
FP_FLAG=""
[ "$FOLD_PARALLEL" = "1" ] && FP_FLAG="--fold_parallel"

echo "== step 0: classmap =="
$PY -m $CLI.create_class_map \
  --train_dfs "$DATA_DIR/train_curated.csv" "$DATA_DIR/train_noisy.csv" \
  --output_file classmap.json

echo "== step 1: curated 5-fold 2d CNN with augmentations =="
$PY -m $CLI.train_2d_cnn \
  --train_df "$DATA_DIR/train_curated.csv" \
  --train_data_dir "$DATA_DIR/train_curated/" \
  --classmap classmap.json \
  --device "$DEVICE" \
  --optimizer adam \
  --folds 0 1 2 3 4 \
  --n_folds 5 \
  --log_interval 10 \
  --batch_size "$BATCH_SIZE" \
  --epochs "$EPOCHS" \
  --accumulation_steps 1 \
  --save_every 20 \
  --num_conv_blocks 5 \
  --conv_base_depth 100 \
  --growth_rate 1.5 \
  --weight_decay 0.0 \
  --start_deep_supervision_on 1 \
  --aggregation_type max \
  --lr 0.003 \
  --scheduler 1cycle_0.0001_0.005 \
  --test_data_dir "$DATA_DIR/test" \
  --sample_submission "$DATA_DIR/sample_submission.csv" \
  --num_workers 8 \
  --output_dropout 0.5 \
  --p_mixup 0.5 \
  --switch_off_augmentations_on $((EPOCHS * 9 / 10)) \
  --features mel_2048_1024_128 \
  --max_audio_length 15 \
  --p_aug 0.75 \
  --label parity_2d_cnn $FP_FLAG

EXP=$(ls -dt experiments/* | head -1)
echo "curated experiment: $EXP"

$PY -m $CLI.compare_to_baseline \
  --experiment "$EXP" \
  --train_df "$DATA_DIR/train_curated.csv" \
  --classmap classmap.json \
  ${REFERENCE_LWLRAP:+--reference_lwlrap "$REFERENCE_LWLRAP"} \
  ${REFERENCE_OOF_DIR:+--reference_oof_dir "$REFERENCE_OOF_DIR"}

if [ "${SKIP_NOISY:-0}" = "1" ]; then
  echo "SKIP_NOISY=1 — stopping after the curated stage"
  exit 0
fi

echo "== step 2: score the noisy set with the curated model =="
$PY -m $CLI.predict_2d_cnn \
  --experiment "$EXP" \
  --test_df "$DATA_DIR/train_noisy.csv" \
  --test_data_dir "$DATA_DIR/train_noisy/" \
  --output_df predictions/noisy_probabilities.csv \
  --classmap classmap.json \
  --device "$DEVICE"

$PY -m $CLI.relabel_noisy_data \
  --noisy_df "$DATA_DIR/train_noisy.csv" \
  --noisy_predictions_df predictions/noisy_probabilities.csv \
  --output_df predictions/train_noisy_relabeled_1k.csv \
  --mode scoring_1000

echo "== step 3: curated + top-1k noisy round =="
$PY -m $CLI.train_2d_cnn \
  --train_df "$DATA_DIR/train_curated.csv" \
  --train_data_dir "$DATA_DIR/train_curated/" \
  --noisy_train_df predictions/train_noisy_relabeled_1k.csv \
  --noisy_train_data_dir "$DATA_DIR/train_noisy/" \
  --classmap classmap.json \
  --device "$DEVICE" \
  --optimizer adam \
  --folds 0 1 2 3 4 \
  --n_folds 5 \
  --log_interval 10 \
  --batch_size "$BATCH_SIZE" \
  --epochs "$NOISY_EPOCHS" \
  --accumulation_steps 1 \
  --save_every 20 \
  --num_conv_blocks 6 \
  --conv_base_depth 100 \
  --growth_rate 1.5 \
  --weight_decay 0.0 \
  --start_deep_supervision_on 1 \
  --aggregation_type max \
  --lr 0.003 \
  --scheduler 1cycle_0.0001_0.005 \
  --test_data_dir "$DATA_DIR/test" \
  --sample_submission "$DATA_DIR/sample_submission.csv" \
  --num_workers 8 \
  --output_dropout 0.7 \
  --p_mixup 0.5 \
  --switch_off_augmentations_on $((NOISY_EPOCHS * 14 / 15)) \
  --features mel_2048_1024_128 \
  --max_audio_length 15 \
  --p_aug 0.75 \
  --label parity_2d_cnn_noisy_1k $FP_FLAG

EXP2=$(ls -dt experiments/* | head -1)
echo "noisy-round experiment: $EXP2"

$PY -m $CLI.compare_to_baseline \
  --experiment "$EXP2" \
  --train_df "$DATA_DIR/train_curated.csv" \
  --classmap classmap.json \
  ${REFERENCE_LWLRAP:+--reference_lwlrap "$REFERENCE_LWLRAP"} \
  ${REFERENCE_OOF_DIR:+--reference_oof_dir "$REFERENCE_OOF_DIR"}

echo "== step 4: linear blend of the curated + noisy-round experiments =="
$PY -m $CLI.linear_blend \
  --experiments "$EXP" "$EXP2" \
  --train_df "$DATA_DIR/train_curated.csv" \
  --output_df predictions/blend_submission.csv
echo "blend submission: $WORK/predictions/blend_submission.csv"

echo "== done =="
echo "Further pseudolabel rounds (top-2k..5k, then relabelall-replacenan)"
echo "follow the same predict -> relabel -> train pattern; see"
echo "the relabel CLI's --help for its modes."
