#!/usr/bin/env bash
# Two-stage BlendedMVS training recipe (train_blend.sh's) on the PyTorch
# port: one classification-only epoch, then --regress --resume through
# epoch 16. Batch 2 at 768x576 (BlendedMVS native), Adam 1e-3 halved at
# epochs 4/8/12. One process per GPU through torchrun: NGPUS=N trains on
# N cards, each rank on 2/N samples of every global batch of 2.
set -euo pipefail

: "${MVS_TRAINING:=/home/Desktop/BlendedMVS/}"
: "${LOG_DIR:=./checkpoints/blendedmvs}"
: "${NGPUS:=1}"

common=(
    --dataset blendedmvs
    --trainpath="$MVS_TRAINING"
    --trainlist lists/blendedmvs/train.txt
    --vallist lists/blendedmvs/val.txt
    --logdir="$LOG_DIR"
    --batch_size 2 --lr 0.001 --lrepochs 4,8,12:2
    --iteration 4
)

train() {
    torchrun --standalone --nproc_per_node "$NGPUS" -m itermvs_tpu_torch.train "$@"
}

train "${common[@]}" --epochs 1 "$@"
train "${common[@]}" --epochs 16 --regress --resume "$@"
