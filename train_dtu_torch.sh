#!/usr/bin/env bash
# Two-stage DTU training recipe (train_dtu.sh's) on the PyTorch port:
#   stage 1 — one epoch with the classification-only loss;
#   stage 2 — resume with --regress (windowed L1 + confidence terms)
#             through epoch 16. Adam 1e-3 halved at epochs 4/8/12,
#             batch 4 at 640x512, grad clip 2.0.
# One process per GPU through torchrun: NGPUS=N trains on N cards, each
# rank on 4/N samples of every global batch of 4 (N must divide 4).
set -euo pipefail

: "${MVS_TRAINING:=/home/Desktop/dtu/}"
: "${LOG_DIR:=./checkpoints/dtu}"
: "${NGPUS:=1}"

common=(
    --dataset dtu_yao
    --trainpath="$MVS_TRAINING"
    --trainlist lists/dtu/train.txt
    --vallist lists/dtu/val.txt
    --logdir="$LOG_DIR"
    --batch_size 4 --lr 0.001 --lrepochs 4,8,12:2
    --small_image --iteration 4
)

train() {
    torchrun --standalone --nproc_per_node "$NGPUS" -m itermvs_tpu_torch.train "$@"
}

train "${common[@]}" --epochs 1 "$@"
train "${common[@]}" --epochs 16 --regress --resume "$@"
