#!/bin/bash
# VERDICT r2 item 3: wire the pretrained text encoder into the headline
# path. The B arm of the text-encoder A/B at the FULL H&M shape (105k
# items / 1.37M users): same world parquet (symlinked from
# artifacts/quality_hm/world), stage-1 retrained with the frozen
# corpus-pretrained PPMI-SVD embeddings (item_tower.text_encoder=
# pretrained) instead of the trainable hash encoder, then the purity /
# content-profile / stage-2 rows the A arm already has. If the GNN
# artifacts from the A arm exist they are symlinked too (the GNN trains
# on the interaction graph only — content-agnostic) so the hybrid tower
# can ride the pretrained content matrix.
# Stage guards resume exactly like quality_hm_shape.sh.
set -u -o pipefail
cd "$(dirname "$0")/.."
SRC=$(pwd)/artifacts/quality_hm/world
OUT=artifacts/quality_hm_pt
WD=$OUT/world
mkdir -p "$WD"
for f in items.parquet users.parquet transactions.parquet \
         features_item.parquet features_sequence.parquet \
         features_user.parquet targets_val.json; do
  [ -e "$WD/$f" ] || ln -s "$SRC/$f" "$WD/$f"
done
# GNN artifacts (optional — enables distill/hybrid without retraining)
for f in gnn_users.npy gnn_users.ids.json gnn_items.npy gnn_items.ids.json \
         gnn_distilled_items.npy gnn_distilled_items.ids.json; do
  [ -e "$WD/$f" ] || { [ -e "$SRC/$f" ] && ln -s "$SRC/$f" "$WD/$f"; }
done

SETS="--set data.root=$WD --set data.num_items=105000 --set data.num_users=1370000 \
 --set data.days=365 --set data.repeat_prob=0.10 \
 --set item_tower.text_encoder=pretrained"
FAILED=""

run() {  # run <name> <timeout_s> <cmd...>
  # tmp-then-mv: the stage JSON only exists once the stage SUCCEEDED, so
  # the [ -s ... ] resume guards can't skip a failed/timed-out stage that
  # tee'd partial output (ADVICE r3)
  local name=$1 tmo=$2; shift 2
  if timeout "$tmo" python -m recsys.pipeline.cli "$@" $SETS \
      | tee "$OUT/$name.json.tmp"; then
    mv "$OUT/$name.json.tmp" "$OUT/$name.json"
  else
    rm -f "$OUT/$name.json.tmp"; FAILED="$FAILED $name"
  fi
}

[ -s "$OUT/pretrain.json" ] || \
  JAX_PLATFORMS=cpu PYTHONPATH="$(pwd)" python -m recsys.pipeline.cli \
    pretrain-text $SETS | tee "$OUT/pretrain.json" || exit 1
[ -s "$OUT/item.json" ] || run item 7200 train-item --set simcse.epochs=3
[ -z "$FAILED" ] || { echo "HM-PT-FAILED:$FAILED"; exit 1; }
[ -s "$OUT/vectorize.json" ] || run vectorize 3600 vectorize
[ -z "$FAILED" ] || { echo "HM-PT-FAILED:$FAILED"; exit 1; }
[ -s "$OUT/knn_purity.json" ] || \
  PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python scripts/knn_purity.py \
    "$WD" 10 8192 | tee "$OUT/knn_purity.json" || FAILED="$FAILED purity"
[ -s "$OUT/user.json" ] || run user 14400 train-user --set user_train.ckpt_every=5
[ -z "$FAILED" ] || { echo "HM-PT-FAILED:$FAILED"; exit 1; }
if [ -e "$WD/gnn_items.npy" ]; then
  [ -s "$OUT/hybrid.json" ] || run hybrid 10800 train-hybrid \
    --set user_train.epochs=2 --set user_train.ckpt_every=1
fi
[ -s "$OUT/eval.json" ] || run eval 7200 eval
if [ -n "$FAILED" ]; then echo "HM-PT-PARTIAL failed:$FAILED"; exit 1; fi
echo HM-PT-DONE
