#!/usr/bin/env bash
# Test CLI through torchrun (the port's counterpart of tools/dist_test.sh).
#   mmdet3d_gaussian_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS \
#       [test args]
# Run from a directory where python finds the repository.  The test CLI
# predicts and evaluates on rank 0's card; the other ranks return at once.
set -e
CONFIG=$1
CHECKPOINT=$2
GPUS=${3:-1}
shift 3 || shift $#
exec torchrun --standalone --nproc_per_node="$GPUS" \
    --master_port="${PORT:-29500}" \
    -m mmdet3d_gaussian_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
