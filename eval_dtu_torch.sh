#!/usr/bin/env bash
# DTU evaluation on the PyTorch port (eval_dtu.sh's recipe, on NVIDIA
# H100s): per-view depth + confidence inference, then geometric fusion
# to per-scan point clouds (itermvsNNN_l3.ply). Flags mirror eval_dtu.sh
# (eval at 1600x1152, N=5, fusion thresholds 1px / 0.01 rel depth / 0.3
# confidence, geo_mask 4). One process per GPU through torchrun: NGPUS=N
# evaluates on N cards, each rank taking one map of every global batch
# of N. Extra args pass through, e.g. `bash eval_dtu_torch.sh --device cpu`.
set -euo pipefail

: "${DTU_TESTING:=/home/Desktop/dtu/}"
# Default to the vendored self-contained weights (.npz). Override
# CKPT_FILE with a reference torch .ckpt or one of the port's trainer
# (read by itermvs_tpu_torch/weights.py::torch_state_dict).
: "${CKPT_FILE:=./checkpoints/dtu/model_000015.npz}"
: "${OUT_DIR:=./outputs}"
: "${NGPUS:=1}"

torchrun --standalone --nproc_per_node "$NGPUS" -m itermvs_tpu_torch.eval \
    --dataset=dtu_yao_eval \
    --testpath="$DTU_TESTING" \
    --testlist lists/dtu/test.txt \
    --loadckpt "$CKPT_FILE" \
    --outdir="$OUT_DIR" \
    --batch_size="$NGPUS" --n_views 5 --iteration 4 \
    --geo_pixel_thres=1 --geo_depth_thres=0.01 --photo_thres=0.3 \
    "$@"
