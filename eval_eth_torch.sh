#!/usr/bin/env bash
# ETH3D high-res evaluation on the PyTorch port (eval_eth.sh's recipe,
# on NVIDIA H100s): train + test splits at 1920x1280 with N=7 views;
# per-scene geo_mask thresholds applied by the port's eval. Use
# CKPT_FILE to pick DTU- or BlendedMVS-trained weights. One process per
# GPU through torchrun: NGPUS=N evaluates on N cards, each rank taking
# one map of every global batch of N. Extra args pass through.
set -euo pipefail

: "${ETH3D_TESTING:=/home/Desktop/eth3d_high_res_test/}"
# Default to the vendored self-contained weights (.npz). Override
# CKPT_FILE with a reference torch .ckpt or one of the port's trainer
# (read by itermvs_tpu_torch/weights.py::torch_state_dict).
: "${CKPT_FILE:=./checkpoints/dtu/model_000015.npz}"
: "${OUT_DIR:=./outputs}"
: "${NGPUS:=1}"

for split in train test; do
    torchrun --standalone --nproc_per_node "$NGPUS" -m itermvs_tpu_torch.eval \
        --dataset=eth3d --split "$split" \
        --testpath="$ETH3D_TESTING" \
        --loadckpt "$CKPT_FILE" \
        --outdir="$OUT_DIR" \
        --batch_size="$NGPUS" --n_views 7 --iteration 4 \
        --geo_pixel_thres=1 --geo_depth_thres=0.01 --photo_thres=0.3 \
        "$@"
done
