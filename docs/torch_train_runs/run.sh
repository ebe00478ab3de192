#!/usr/bin/env bash
# The port's first trained runs: the shapes recipe
# (yolov4s_shapes_320_fixture.py: configs/shapes/yolov4s_shapes_320.py on
# the committed tests/torch_fixtures/shapes set), 1600 steps of global
# batch 8, once in one process and once in two processes on one card over
# gloo (4 images each, accumulation 1); each run's best_ema.msgpack is
# evaluated by the port's test CLI. Run from the repo root on a machine
# with a CUDA card:
#
#   docs/torch_train_runs/run.sh OUT_DIR [WORK_DIR]
#
# OUT_DIR receives the card's name and power limit, each run's train.log
# and the test CLI's output and report; WORK_DIR (a new temporary
# directory by default) holds the checkpoints and weights.
set -euo pipefail
OUT=$1
WORK=${2:-$(mktemp -d)}
CFG=docs/torch_train_runs/yolov4s_shapes_320_fixture.py
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$OUT/card.txt"

python -m tpudet_torch.tools.train "$CFG" --work-dir "$WORK/one" --no-resume
cp "$WORK/one/train.log" "$OUT/one_process_train.log"
python -m tpudet_torch.tools.test "$CFG" "$WORK/one/best_ema.msgpack" \
    --out "$OUT/one_process_report.json" | tee "$OUT/one_process_test.log"

pids=()
for rank in 0 1; do
    python -m tpudet_torch.tools.train "$CFG" --work-dir "$WORK/two$rank" \
        --no-resume --coordinator "file://$WORK/rendezvous" \
        --num-processes 2 --process-id "$rank" --dist-backend gloo \
        --cfg-options data.samples_per_gpu=4 &
    pids+=($!)
done
for pid in "${pids[@]}"; do
    wait "$pid"
done
cp "$WORK/two0/train.log" "$OUT/two_process_rank0_train.log"
cp "$WORK/two1/train.log" "$OUT/two_process_rank1_train.log"
python -m tpudet_torch.tools.test "$CFG" "$WORK/two0/best_ema.msgpack" \
    --out "$OUT/two_process_report.json" | tee "$OUT/two_process_test.log"
