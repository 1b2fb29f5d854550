#!/bin/bash
# Long-run quality chase (ROADMAP): v2 persona world, full stack, stage-2
# trained into the reference's long-run regime (its 17.55% best was epoch 26).
# Also emits the new popularity/repurchase baselines for context.
set -u
cd "$(dirname "$0")/.."
WD=${1:-artifacts/quality_long}
EPOCHS=${2:-30}
SETS="--set data.root=$WD --set data.num_items=2000 --set data.num_users=1000 --set data.days=120"
mkdir -p "$WD"

python -m recsys.pipeline.cli gen-data $SETS | tee "$WD/gen.json" || exit 1
python -m recsys.pipeline.cli etl $SETS | tee "$WD/etl.json" || exit 1
timeout 3600 python -m recsys.pipeline.cli train-item $SETS \
  --set simcse.epochs=3 | tee "$WD/item.json" || exit 1
python -m recsys.pipeline.cli vectorize $SETS || exit 1
timeout 10800 python -m recsys.pipeline.cli train-user $SETS \
  --set user_train.loss_variant=margin --set user_train.epochs=$EPOCHS \
  | tee "$WD/user.json" || exit 1
python -m recsys.pipeline.cli eval $SETS | tee "$WD/eval.json"
timeout 3600 python -m recsys.pipeline.cli train-gnn $SETS \
  --set gnn.epochs=10 | tee "$WD/gnn.json"
python -m recsys.pipeline.cli distill $SETS | tee "$WD/distill.json"
timeout 7200 python -m recsys.pipeline.cli train-hybrid $SETS \
  | tee "$WD/hybrid.json"
python -m recsys.pipeline.cli train-reranker $SETS | tee "$WD/reranker.json"
echo QUALITY-LONG-DONE
