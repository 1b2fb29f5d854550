#!/bin/bash
# Reference-catalog-scale quality run: 47k items (the reference's H&M
# catalog size) / 200k users / 365 days. Full stack: stage-1 -> vectorize
# -> stage-2 (reference config: 15 epochs, bs 768) -> GNN -> distill ->
# hybrid -> reranker -> eval.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_xl
WD=$OUT/world
mkdir -p "$WD"
SETS="--set data.root=$WD --set data.num_items=47000 --set data.num_users=200000 --set data.days=365"

python -m recsys.pipeline.cli gen-data $SETS || exit 1
python -m recsys.pipeline.cli etl $SETS | tee "$OUT/etl.json" || exit 1
timeout 7200 python -m recsys.pipeline.cli train-item $SETS \
  --set simcse.epochs=3 | tee "$OUT/item.json" || exit 1
python -m recsys.pipeline.cli vectorize $SETS || exit 1
timeout 10800 python -m recsys.pipeline.cli train-user $SETS \
  --set user_train.ckpt_every=5 | tee "$OUT/user.json"
timeout 7200 python -m recsys.pipeline.cli train-gnn $SETS \
  --set gnn.epochs=5 | tee "$OUT/gnn.json"
timeout 3600 python -m recsys.pipeline.cli distill $SETS | tee "$OUT/distill.json"
timeout 10800 python -m recsys.pipeline.cli train-hybrid $SETS \
  | tee "$OUT/hybrid.json"
timeout 3600 python -m recsys.pipeline.cli train-reranker $SETS \
  | tee "$OUT/reranker.json"
timeout 3600 python -m recsys.pipeline.cli eval $SETS | tee "$OUT/eval.json"
echo XL-DONE
