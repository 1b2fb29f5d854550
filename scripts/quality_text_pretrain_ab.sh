#!/bin/bash
# A/B: trainable HashTextEncoder vs frozen corpus-pretrained PPMI-SVD
# embeddings (item_tower.text_encoder=pretrained) on the v3 mid world.
# Metric: stage-1 kNN@10 cluster purity vs the latent generator clusters
# (hash-encoder round-1 anchor: 0.151; feature-oracle ceiling ~0.30).
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/text_pretrain_ab
mkdir -p "$OUT"
WDA=$OUT/world_hash
WDB=$OUT/world_pretrained
BASE="--set data.num_items=5000 --set data.num_users=3000 --set data.days=240"

python -m recsys.pipeline.cli gen-data $BASE --set data.root=$WDA || exit 1
mkdir -p "$WDB"
cp "$WDA"/items.parquet "$WDA"/users.parquet "$WDA"/transactions.parquet "$WDB"/

for ARM in hash pretrained; do
  WD=$([ "$ARM" = hash ] && echo "$WDA" || echo "$WDB")
  SETS="$BASE --set data.root=$WD --set item_tower.text_encoder=$ARM"
  python -m recsys.pipeline.cli etl $SETS | tee "$OUT/etl_$ARM.json" || exit 1
  if [ "$ARM" = pretrained ]; then
    python -m recsys.pipeline.cli pretrain-text $SETS \
      | tee "$OUT/pretrain.json" || exit 1
  fi
  timeout 5400 python -m recsys.pipeline.cli train-item $SETS \
    --set simcse.epochs=3 | tee "$OUT/item_$ARM.json" || exit 1
  python -m recsys.pipeline.cli vectorize $SETS || exit 1
  python scripts/knn_purity.py "$WD" | tee "$OUT/purity_$ARM.json" || exit 1
done
echo TEXT-PRETRAIN-AB-DONE
