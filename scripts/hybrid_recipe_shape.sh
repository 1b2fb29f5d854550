#!/bin/bash
# Apply the winning hybrid training recipe (mid-shape arms in
# artifacts/hybrid_recipe: lowlr_steps 0.273@100 vs control 0.248, both
# improving monotonically) at the H&M shape. Runs in a SYMLINKED world
# copy so the headline campaign's ckpt_hybrid / rerank artifacts stay
# untouched. Run only after quality_hm_v4_stage2.sh's hybrid+rerank
# stages are done (chip contention).
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_hm_v4
SRC=$(pwd)/$OUT/world
WD=$OUT/world_rcp
mkdir -p "$WD"
for f in items.parquet users.parquet transactions.parquet \
         features_item.parquet features_sequence.parquet \
         features_user.parquet targets_val.json \
         item_matrix.npy item_matrix.ids.json \
         gnn_users.npy gnn_users.ids.json gnn_items.npy gnn_items.ids.json \
         gnn_distilled_items.npy gnn_distilled_items.ids.json \
         gnn_distilled_users.npy gnn_distilled_users.ids.json \
         gnn_eval.json; do
  [ -e "$WD/$f" ] || { [ -e "$SRC/$f" ] && ln -s "$SRC/$f" "$WD/$f"; }
done
SETS="--set data.root=$WD --set data.num_items=105000 --set data.num_users=1370000 \
 --set data.days=365 --set data.repeat_prob=0.10 --set data.name_style_words=2"

if [ -s "$OUT/hybrid_recipe_shape.json" ]; then echo "skip (done)"; exit 0; fi
if timeout 14400 python -m recsys.pipeline.cli train-hybrid $SETS \
    --set user_train.epochs=4 --set user_train.ckpt_every=1 \
    --set user_train.hybrid_lr=1e-4 --set user_train.hybrid_warmup_steps=100 \
    --set user_train.hybrid_lr_decay=cosine \
    2> >(tail -60 > "$OUT/hybrid_recipe_shape.stderr") \
    | tee "$OUT/hybrid_recipe_shape.json.tmp"; then
  mv "$OUT/hybrid_recipe_shape.json.tmp" "$OUT/hybrid_recipe_shape.json"
  echo RECIPE-SHAPE-DONE
else
  rm -f "$OUT/hybrid_recipe_shape.json.tmp"; echo RECIPE-SHAPE-FAILED; exit 1
fi
