#!/bin/bash
# Loss-zoo ablation + world scaling (ROADMAP quality targets).
# Stage-1/vectorize once per world, then stage-2 per loss variant.
set -u
cd "$(dirname "$0")/.."
OUT=artifacts/quality_ablation
mkdir -p "$OUT"

run_world () {          # $1 = tag, $2.. = world SETS
  local tag=$1; shift
  local WD="$OUT/$tag"
  local SETS="--set data.root=$WD $*"
  python -m recsys.pipeline.cli gen-data $SETS || return 1
  python -m recsys.pipeline.cli etl $SETS | tee "$OUT/$tag.etl.json"
  timeout 3600 python -m recsys.pipeline.cli train-item $SETS \
    --set simcse.epochs=3 | tee "$OUT/$tag.item.json"
  python -m recsys.pipeline.cli vectorize $SETS
  for variant in logq hnm mixed_hnm margin; do
    rm -rf "$WD/ckpt_user"
    timeout 5400 python -m recsys.pipeline.cli train-user $SETS \
      --set user_train.loss_variant=$variant --set user_train.epochs=12 \
      | tee "$OUT/$tag.user.$variant.json"
  done
  # temperature probe on the default variant
  rm -rf "$WD/ckpt_user"
  timeout 5400 python -m recsys.pipeline.cli train-user $SETS \
    --set user_train.temperature=0.15 --set user_train.epochs=12 \
    | tee "$OUT/$tag.user.logq_t015.json"
}

run_world v2 --set data.num_items=2000 --set data.num_users=1000 --set data.days=120
run_world mid --set data.num_items=5000 --set data.num_users=3000 --set data.days=240
echo ABLATION-DONE
