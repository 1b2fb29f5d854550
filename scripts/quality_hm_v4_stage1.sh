#!/bin/bash
# Round-4 campaign phase 1 — stage-1 A/B at the H&M shape on the
# content-realistic v4 world (VERDICT r3 item 2): trainable hash text
# encoder vs frozen corpus-pretrained PPMI-SVD embeddings, both measured
# by kNN@10 cluster purity vs the generator's latent micro-style
# clusters. The winner's item matrix becomes the campaign's content
# matrix (phase 2 copies it in).
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_hm_v4
WD=$OUT/world
WDP=$OUT/world_pt
BASE="--set data.num_items=105000 --set data.num_users=1370000 \
 --set data.days=365 --set data.repeat_prob=0.10 --set data.name_style_words=2"
FAILED=""

run() {  # run <name> <timeout_s> <extra-sets> <cmd...>
  local name=$1 tmo=$2 sets=$3; shift 3
  if [ -s "$OUT/$name.json" ]; then echo "skip $name"; return 0; fi
  if timeout "$tmo" python -m recsys.pipeline.cli "$@" $BASE $sets \
      2> >(tail -40 > "$OUT/$name.stderr") | tee "$OUT/$name.json.tmp"; then
    mv "$OUT/$name.json.tmp" "$OUT/$name.json"
  else
    rm -f "$OUT/$name.json.tmp"; FAILED="$FAILED $name"
  fi
}

purity() {  # purity <name> <world>
  local name=$1 wd=$2
  if [ -s "$OUT/$name.json" ]; then echo "skip $name"; return 0; fi
  if JAX_PLATFORMS=cpu PYTHONPATH=$(pwd) timeout 3600 \
      python scripts/knn_purity.py "$wd" 10 8192 | tee "$OUT/$name.json.tmp"; then
    mv "$OUT/$name.json.tmp" "$OUT/$name.json"
  else
    rm -f "$OUT/$name.json.tmp"; FAILED="$FAILED $name"
  fi
}

# ---- arm A: hash encoder (the r1-r3 headline configuration)
run item 7200 "--set data.root=$WD" train-item --set simcse.epochs=3
[ -z "$FAILED" ] && run vectorize 3600 "--set data.root=$WD" vectorize
purity knn_purity "$WD"
[ -z "$FAILED" ] || { echo "V4-STAGE1-FAILED:$FAILED"; exit 1; }

# ---- arm B: frozen corpus-pretrained text embeddings (same world data)
mkdir -p "$WDP"
for f in items.parquet users.parquet transactions.parquet \
         features_item.parquet features_sequence.parquet \
         features_user.parquet targets_val.json; do
  [ -e "$WDP/$f" ] || ln -s "$(pwd)/$WD/$f" "$WDP/$f"
done
PTSETS="--set data.root=$WDP --set item_tower.text_encoder=pretrained"
if [ ! -s "$OUT/pretrain.json" ]; then
  if JAX_PLATFORMS=cpu timeout 3600 python -m recsys.pipeline.cli \
      pretrain-text $BASE $PTSETS | tee "$OUT/pretrain.json.tmp"; then
    mv "$OUT/pretrain.json.tmp" "$OUT/pretrain.json"
  else rm -f "$OUT/pretrain.json.tmp"; echo "V4-STAGE1-FAILED: pretrain"; exit 1; fi
fi
run item_pt 7200 "$PTSETS" train-item --set simcse.epochs=3
[ -z "$FAILED" ] && run vectorize_pt 3600 "$PTSETS" vectorize
purity knn_purity_pt "$WDP"
[ -z "$FAILED" ] || { echo "V4-STAGE1-FAILED:$FAILED"; exit 1; }
echo V4-STAGE1-DONE
