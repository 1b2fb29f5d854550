#!/bin/bash
# Mid-world (v3 latent-cluster) diagnostic stack: content-profile baseline
# vs towers vs cluster oracle. Full pipeline incl. GNN + hybrid.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_mid_diag
WD=$OUT/world
mkdir -p "$OUT"
SETS="--set data.root=$WD --set data.num_items=5000 --set data.num_users=3000 --set data.days=240"

python -m recsys.pipeline.cli gen-data $SETS | tee "$OUT/gen.json" || exit 1
python -m recsys.pipeline.cli etl $SETS | tee "$OUT/etl.json" || exit 1
timeout 3600 python -m recsys.pipeline.cli train-item $SETS \
  --set simcse.epochs=3 | tee "$OUT/item.json" || exit 1
python -m recsys.pipeline.cli vectorize $SETS || exit 1
timeout 7200 python -m recsys.pipeline.cli train-user $SETS \
  --set user_train.loss_variant=margin --set user_train.epochs=12 \
  | tee "$OUT/user.json" || exit 1
timeout 3600 python -m recsys.pipeline.cli eval $SETS \
  | tee "$OUT/eval.json" || exit 1
timeout 3600 python -m recsys.pipeline.cli train-gnn $SETS \
  | tee "$OUT/gnn.json" || exit 1
timeout 1200 python -m recsys.pipeline.cli distill $SETS \
  | tee "$OUT/distill.json" || exit 1
timeout 7200 python -m recsys.pipeline.cli train-hybrid $SETS \
  | tee "$OUT/hybrid.json" || exit 1
echo MID-DIAG-DONE
