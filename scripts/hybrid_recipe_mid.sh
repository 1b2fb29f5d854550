#!/bin/bash
# VERDICT r3 item 6: hybrid training-recipe arms at mid shape (5k items /
# 3k users / 240 d, v4 style-word names). Goal: a recipe where
# hybrid_best BEATS the epoch-1 passthrough value (rounds 1-3: training
# degraded it monotonically). Runs fully on CPU (the chip belongs to the
# headline campaign). Arms share one world + stage-1 + GNN artifacts;
# checkpoints are wiped between arms so restore-best can't cross arms.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/hybrid_recipe
WD=$OUT/world
mkdir -p "$WD"
export JAX_PLATFORMS=cpu
SETS="--set data.root=$WD --set data.num_items=5000 --set data.num_users=3000 \
 --set data.days=240 --set data.name_style_words=2"

stage() {  # stage <name> <timeout> <cmd...>
  local name=$1 tmo=$2; shift 2
  if [ -s "$OUT/$name.json" ]; then echo "skip $name"; return 0; fi
  if timeout "$tmo" python -m recsys.pipeline.cli "$@" $SETS \
      2> >(tail -30 > "$OUT/$name.stderr") | tee "$OUT/$name.json.tmp"; then
    mv "$OUT/$name.json.tmp" "$OUT/$name.json"
  else
    rm -f "$OUT/$name.json.tmp"; echo "RECIPE-FAILED: $name"; exit 1
  fi
}

stage gen 3600 gen-data
stage etl 3600 etl
stage item 10800 train-item --set simcse.epochs=3
stage vectorize 3600 vectorize
stage gnn 10800 train-gnn
stage distill 3600 distill

arm() {  # arm <name> <extra --set args...>
  local name=$1; shift
  if [ -s "$OUT/hybrid_$name.json" ]; then echo "skip arm $name"; return 0; fi
  rm -rf "$WD/ckpt_hybrid"
  if timeout 14400 python -m recsys.pipeline.cli train-hybrid $SETS \
      --set user_train.epochs=8 --set user_train.ckpt_every=1 "$@" \
      2> >(tail -30 > "$OUT/hybrid_$name.stderr") \
      | tee "$OUT/hybrid_$name.json.tmp"; then
    mv "$OUT/hybrid_$name.json.tmp" "$OUT/hybrid_$name.json"
  else
    rm -f "$OUT/hybrid_$name.json.tmp"; echo "RECIPE-ARM-FAILED: $name"
  fi
}

arm control
arm lowlr_cosine --set user_train.hybrid_lr=5e-5 \
  --set user_train.hybrid_warmup_steps=50 --set user_train.hybrid_lr_decay=cosine
arm slow_adapters --set user_train.hybrid_warmup_steps=50 \
  --set 'user_train.hybrid_slow_modules=["item_adapter","encoder","id_embedding"]' \
  --set user_train.hybrid_slow_scale=0.1
arm lowlr_steps --set user_train.hybrid_lr=1e-4 \
  --set user_train.hybrid_warmup_steps=100 --set user_train.hybrid_lr_decay=cosine \
  --set user_train.hybrid_steps_per_epoch_min=32
echo RECIPE-DONE
