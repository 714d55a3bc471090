#!/usr/bin/env bash
# Data-parallel training on one host: one process per card through torchrun
# (the port's counterpart of tools/dist_train.sh).
#   mmdet3d_gaussian_tpu_torch/tools/dist_train.sh CONFIG GPUS [train args]
# Run from a directory where python finds the repository (its root, or
# PYTHONPATH set to it).  The train CLI reads torchrun's environment
# (--distributed) and splits each global batch of samples_per_gpu over the
# ranks.  PORT picks the rendezvous port (default 29500).
set -e
CONFIG=$1
GPUS=${2:-1}
shift 2 || shift $#
exec torchrun --standalone --nproc_per_node="$GPUS" \
    --master_port="${PORT:-29500}" \
    -m mmdet3d_gaussian_tpu_torch.tools.train "$CONFIG" --distributed "$@"
