#!/bin/bash
# Mid/large-world stage-2 rerun with reference-scale step counts
# (steps_per_epoch_min=100 default). The original loss-zoo ablation ran
# ONE optimizer step per epoch on these worlds (see RESULTS.md); this
# re-measures the leaders (logq, margin) properly trained.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_steps_floor
mkdir -p "$OUT"

run_world () {          # $1 = tag, $2.. = world SETS
  local tag=$1; shift
  local WD="$OUT/$tag"
  local SETS="--set data.root=$WD $*"
  python -m recsys.pipeline.cli gen-data $SETS || return 1
  python -m recsys.pipeline.cli etl $SETS | tee "$OUT/$tag.etl.json" || return 1
  timeout 3600 python -m recsys.pipeline.cli train-item $SETS \
    --set simcse.epochs=3 | tee "$OUT/$tag.item.json" || return 1
  python -m recsys.pipeline.cli vectorize $SETS || return 1
  for variant in logq margin; do
    rm -rf "$WD/ckpt_user"
    timeout 7200 python -m recsys.pipeline.cli train-user $SETS \
      --set user_train.loss_variant=$variant --set user_train.epochs=12 \
      | tee "$OUT/$tag.user.$variant.json"
  done
}

run_world mid --set data.num_items=5000 --set data.num_users=3000 --set data.days=240
run_world large --set data.num_items=10000 --set data.num_users=5000 --set data.days=240
echo STEPS-FLOOR-DONE
