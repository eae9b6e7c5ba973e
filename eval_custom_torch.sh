#!/usr/bin/env bash
# Custom-scene evaluation on the PyTorch port (eval_custom.sh's recipe,
# on NVIDIA H100s): a COLMAP scene converted by tools/colmap_input.py
# (images/ cams_1/ pair.txt). Set --img_wh to your resolution (multiples
# of 32). One process per GPU through torchrun: NGPUS=N evaluates on N
# cards, each rank taking one map of every global batch of N. Extra args
# pass through.
set -euo pipefail

: "${CUSTOM_TESTING:=/home/Desktop/custom/}"
# Default to the vendored self-contained weights (.npz). Override
# CKPT_FILE with a reference torch .ckpt or one of the port's trainer
# (read by itermvs_tpu_torch/weights.py::torch_state_dict).
: "${CKPT_FILE:=./checkpoints/dtu/model_000015.npz}"
: "${OUT_DIR:=./outputs}"
: "${NGPUS:=1}"

torchrun --standalone --nproc_per_node "$NGPUS" -m itermvs_tpu_torch.eval \
    --dataset=custom \
    --testpath="$CUSTOM_TESTING" \
    --loadckpt "$CKPT_FILE" \
    --outdir="$OUT_DIR" \
    --batch_size="$NGPUS" --n_views 7 --iteration 4 --img_wh 640 480 \
    --geo_pixel_thres=1 --geo_depth_thres=0.01 --photo_thres=0.3 \
    "$@"
